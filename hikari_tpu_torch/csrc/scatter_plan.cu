// Phases A and B of the cluster-major scatter tracer, for Hopper (sm_90a):
// the entered (ray, 128-triangle cluster) pairs, counted per ray chunk and
// cluster, then each pair's ray id written into its slot of the
// cluster-major item array. Built by hikari_tpu_torch/trace/scatter.py
// with nvcc into a shared library with a plain C interface, loaded with
// ctypes.
//
// Replaces: hikari_tpu/trace/scatter.py `trace_scatter`'s phase A
// (`count_body` under `lax.scan`, :242-254) and phase B (`scatter_body`,
// :273-294): per chunk of rays the entered mask (`_chunk_mask`), its
// per-cluster sums, and the slots offsets[c] + running[c] + in-chunk
// cumsum rank, scattered with mode="drop". The JAX package sorts nothing,
// and neither does this.
//
// Two launches on one stream, with plain torch between them
// (trace/scatter.py scatter_plan):
//   1. count: per chunk of 512 rays (one block) and cluster, the entered
//      pairs, into counts (NCH, L) i32. Integer sums only;
//   2. torch: the exclusive scan of the counts over the chunks, the block
//      map of the per-cluster totals, and base[chunk, c] = offsets[c] +
//      the pairs of the chunks before, clamped to CAP;
//   3. place: the slab test again; the pair of ray r (chunk n, cluster c)
//      goes to slot base[n, c] + the entered rays of the chunk before r,
//      counted by ballots: a popc of the lanes below in the warp plus the
//      warps below, summed from shared memory. A slot at or past CAP is
//      dropped (the wrapper counts the drops from the totals). No atomics:
//      every slot has one writer and its value does not depend on the
//      schedule. Within a cluster the rays ascend, as in the twin's order.
//
// Inputs (the contract of the plain twin `scatter_plan_reference` in
// trace/scatter.py): o, inv (R,3) f32 (inv = safe_inv_dir(d)); maxd (R,)
// f32; lo, hi (R,) i32; cmin, cmax (L,3) f32; cvalid (L,) bool. The slab
// test, its NaN rule and the int prim-range test are in slab_test.cuh; a
// pair enters exactly where the twin's `_chunk_mask` is true.
//
// What bounds it on this card: operations. Each launch makes every
// ray/cluster test, ~30 FP32 operations (at 262,144 rays x 4,305 clusters,
// 1.13 G tests a launch, ~0.5 ms at 67 TFLOP/s); the bytes (rays, bounds,
// counts and bases of (NCH, L) i32, the items) are tens of MB. The design
// is phase 1's (tile_entries.cu): one ray per thread, clusters in batches
// of 32 staged in shared memory, lane k of each warp keeping cluster k's
// ballot.

#include "slab_test.cuh"

namespace {

using hikari_slab::Bounds;
using hikari_slab::kBatch;
using hikari_slab::kFull;
using hikari_slab::SlabRay;

constexpr int kChunk = 512;  // rays per block: the chunk of the counts (scatter.PLAN_CHUNK)
constexpr int kWarps = kChunk / 32;
constexpr int kCluster = 128;

template <bool kPlace>
__global__ void __launch_bounds__(kChunk)
    scatter_plan_kernel(const float* __restrict__ o, const float* __restrict__ inv,
                        const float* __restrict__ maxd, const int* __restrict__ lo,
                        const int* __restrict__ hi, const float* __restrict__ cmin,
                        const float* __restrict__ cmax, const unsigned char* __restrict__ cvalid,
                        int num_rays, int num_clusters, int* __restrict__ counts,
                        const int* __restrict__ base, int cap, long long* __restrict__ items) {
  __shared__ Bounds bounds;
  __shared__ int warp_count[kWarps][kBatch];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ray = blockIdx.x * kChunk + threadIdx.x;
  const bool live = ray < num_rays;  // the last chunk may be ragged
  SlabRay<int> r = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0, 0};
  if (live) {
    r.ox = o[3 * ray];
    r.oy = o[3 * ray + 1];
    r.oz = o[3 * ray + 2];
    r.ix = inv[3 * ray];
    r.iy = inv[3 * ray + 1];
    r.iz = inv[3 * ray + 2];
    r.maxd = maxd[ray];
    r.lo = lo[ray];
    r.hi = hi[ray];
  }
  const unsigned below = (1u << lane) - 1u;  // the lanes below this one
  const size_t row = static_cast<size_t>(blockIdx.x) * num_clusters;

  for (int c0 = 0; c0 < num_clusters; c0 += kBatch) {
    const int nk = min(kBatch, num_clusters - c0);
    // Past the last barrier every warp has read the previous batch's bounds
    // and counts.
    hikari_slab::stage_bounds<int>(bounds, cmin, cmax, cvalid, c0, nk, kCluster);
    __syncthreads();
    unsigned mine = 0u;  // lane k: the warp's ballot for cluster c0 + k
    for (int k = 0; k < nk; ++k) {
      float entry;
      const bool hit = live && hikari_slab::slab_hit(bounds.a[k], bounds.b[k], r, entry);
      const unsigned m = __ballot_sync(kFull, hit);
      if (lane == k) mine = m;
    }
    warp_count[warp][lane] = __popc(mine);
    __syncthreads();
    if (!kPlace) {
      if (warp == 0 && lane < nk) {
        int n = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) n += warp_count[w][lane];
        counts[row + c0 + lane] = n;
      }
      continue;
    }
    // Lane k: the first slot of this warp's pairs in cluster c0 + k.
    int first = 0;
    if (lane < nk) {
      first = base[row + c0 + lane];
      for (int w = 0; w < warp; ++w) first += warp_count[w][lane];
    }
    for (int k = 0; k < nk; ++k) {
      const unsigned m = __shfl_sync(kFull, mine, k);
      if (m == 0u) continue;  // the same for the whole warp
      const int slot = __shfl_sync(kFull, first, k) + __popc(m & below);
      if (((m >> lane) & 1u) && slot < cap) items[slot] = ray;
    }
  }
}

}  // namespace

// The count launch (count = 1: counts (NCH, L) written) or the place
// launch (count = 0: items written at base + rank, below cap), NCH =
// ceil(R / 512) blocks.
extern "C" int hikari_scatter_plan(const float* o, const float* inv, const float* maxd,
                                   const int* lo, const int* hi, const float* cmin,
                                   const float* cmax, const unsigned char* cvalid, int num_rays,
                                   int num_clusters, int count, int* counts, const int* base,
                                   int cap, long long* items, void* stream) {
  if (num_rays <= 0 || num_clusters <= 0) return static_cast<int>(cudaSuccess);
  const int blocks = (num_rays + kChunk - 1) / kChunk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (count)
    scatter_plan_kernel<false><<<blocks, kChunk, 0, s>>>(
        o, inv, maxd, lo, hi, cmin, cmax, cvalid, num_rays, num_clusters, counts, base, cap,
        items);
  else
    scatter_plan_kernel<true><<<blocks, kChunk, 0, s>>>(
        o, inv, maxd, lo, hi, cmin, cmax, cvalid, num_rays, num_clusters, counts, base, cap,
        items);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* hikari_scatter_plan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
