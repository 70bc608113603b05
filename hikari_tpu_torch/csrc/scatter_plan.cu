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
// Two calls on one stream, with plain torch between them
// (trace/scatter.py scatter_plan):
//   1. count (hikari_scatter_plan_count): the staged table
//      (slab_test.cuh), then one slab test a (ray, cluster) pair: per
//      chunk of 512 rays (one block, 16 warps) and cluster the entered
//      pairs, into counts (NCH, L) i32, and every warp's 32-bit ballot of
//      every cluster into masks (ceil(R/32), L) u32 (row: the warp's 32
//      rays; bit k: ray 32*row + k enters);
//   2. torch: the exclusive scan of the counts over the chunks, the block
//      map of the per-cluster totals, and base[chunk, c] = offsets[c] +
//      the pairs of the chunks before, clamped to CAP;
//   3. place (hikari_scatter_plan_place): no slab test. One thread a
//      (chunk, cluster) walks the chunk's 16 masks of the cluster in ray
//      order: the pair of ray r goes to slot base[chunk, c] + the entered
//      rays of the chunk before r (the popcounts of the warps below plus
//      the bits below in its own mask). A slot at or past CAP is dropped
//      (the wrapper counts the drops from the totals). No atomics: every
//      slot has one writer and its value does not depend on the schedule.
//      Within a cluster the rays ascend, as in the twin's order.
//
// Inputs (the contract of the plain twin `scatter_plan_reference` in
// trace/scatter.py): o, inv (R,3) f32 (inv = safe_inv_dir(d)); maxd (R,)
// f32; lo, hi (R,) i32; cmin, cmax (L,3) f32; cvalid (L,) bool. The slab
// test, its NaN rule and the int prim-range test are in slab_test.cuh; a
// pair enters exactly where the twin's `_chunk_mask` is true.
//
// What bounds it on this card: operations. The count launch makes every
// ray/cluster test once, ~30 FP32 operations (at 262,144 rays x 4,305
// clusters, 1.13 G tests, ~0.5 ms at 67 TFLOP/s); the bytes (rays, bounds,
// counts and bases of (NCH, L) i32, the masks written once and read once,
// the items) are a few hundred MB at most, ~0.1 ms at (e). The count
// kernel's design:
//   - one ray per thread, its o, inv, max distance and range in registers,
//     at most 32 registers so that four blocks of 512 fit on an SM;
//   - the table in stages of kStage clusters, double-buffered by cp.async
//     (one barrier a stage); every lane reads the same 32-byte row, a
//     broadcast;
//   - per warp a vote whether all its rays are clean, whether all take
//     every cluster's range and whether all share one octant: the test
//     without NaN compares, without range compares and without the
//     per-axis min and max, where they cannot matter (slab_test.cuh);
//   - per test one ballot, stored by lane 0 into the warp's row of the
//     stage in shared memory (no per-lane select); after the stage each
//     warp writes its row of masks (coalesced) and, behind the next
//     stage's barrier, thread k sums the 16 warps' popcounts of cluster k.

#include "slab_test.cuh"

namespace {

using hikari_slab::kFull;
using hikari_slab::kStage;
using hikari_slab::SlabRay;

constexpr int kChunk = 512;  // rays per block: the chunk of the counts (scatter.PLAN_CHUNK)
constexpr int kWarps = kChunk / 32;
constexpr int kCluster = 128;
constexpr int kPlaceThreads = 256;  // clusters per place block

// The tests of one stage for one warp in the form kMode (slab_test.cuh
// warp_mode): the ballot of cluster k into wmask[k].
template <int kMode>
__device__ __forceinline__ void count_stage(const float4* rows, int nk, const SlabRay<int>& r,
                                            unsigned* wmask, bool lane0) {
#pragma unroll 4
  for (int k = 0; k < nk; ++k) {
    float tlo, thi;
    bool ok;
    hikari_slab::slab<kMode>(rows[2 * k], rows[2 * k + 1], r, tlo, thi, ok);
    const float entry = fmaxf(tlo, 0.f);  // compares only: the zero's sign does not matter
    const unsigned m = __ballot_sync(kFull, ok & (thi >= entry) & (entry < r.maxd));
    if (lane0) wmask[k] = m;
  }
}

__global__ void __launch_bounds__(kChunk, 4)
    scatter_plan_count_kernel(const float* __restrict__ o, const float* __restrict__ inv,
                              const float* __restrict__ maxd, const int* __restrict__ lo,
                              const int* __restrict__ hi, const float4* __restrict__ table,
                              int num_rays, int num_clusters, int* __restrict__ counts,
                              unsigned* __restrict__ masks) {
  __shared__ __align__(16) float4 rows[2][2 * kStage];
  __shared__ unsigned wmask[2][kWarps][kStage];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ray = blockIdx.x * kChunk + threadIdx.x;
  // The last chunk may be ragged: a ray past the end is clean, takes every
  // range and enters nothing (max distance -inf).
  SlabRay<int> r = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 1.f, 1.f, 1.f, -__int_as_float(0x7f800000),
                    INT32_MIN, INT32_MAX};
  if (ray < num_rays) {
    r.lx = r.hx = o[3 * ray];
    r.ly = r.hy = o[3 * ray + 1];
    r.lz = r.hz = o[3 * ray + 2];
    r.ix = inv[3 * ray];
    r.iy = inv[3 * ray + 1];
    r.iz = inv[3 * ray + 2];
    r.maxd = maxd[ray];
    r.lo = lo[ray];
    r.hi = hi[ray];
  }
  const int mode = hikari_slab::warp_mode(r, kCluster, (num_clusters - 1) * kCluster);
  const bool lane0 = lane == 0;
  const int mask_rows = (num_rays + 31) / 32;
  const int row = blockIdx.x * kWarps + warp;  // this warp's row of masks
  const int stages = (num_clusters + kStage - 1) / kStage;

  hikari_slab::copy_stage(rows[0], table, 0, num_clusters);
  for (int s = 0; s <= stages; ++s) {
    hikari_slab::wait_copies();
    // Past this barrier stage s is in rows[s & 1], every warp is done with
    // stage s - 1's rows and has stored its ballots of stage s - 1.
    __syncthreads();
    if (s + 1 < stages) hikari_slab::copy_stage(rows[(s + 1) & 1], table, s + 1, num_clusters);
    if (s > 0) {  // the counts of stage s - 1
      const int c0 = (s - 1) * kStage, nk = min(kStage, num_clusters - c0);
      if (threadIdx.x < nk) {
        int n = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) n += __popc(wmask[(s - 1) & 1][w][threadIdx.x]);
        counts[static_cast<size_t>(blockIdx.x) * num_clusters + c0 + threadIdx.x] = n;
      }
    }
    if (s == stages) break;
    const int c0 = s * kStage, nk = min(kStage, num_clusters - c0);
    unsigned* wm = wmask[s & 1][warp];
    const float4* rs = rows[s & 1];
    hikari_slab::with_mode(
        mode, [&](auto m) { count_stage<decltype(m)::value>(rs, nk, r, wm, lane0); });
    __syncwarp();
    if (row < mask_rows)
      for (int k = lane; k < nk; k += 32)
        masks[static_cast<size_t>(row) * num_clusters + c0 + k] = wm[k];
  }
}

// One thread a (chunk, cluster): the chunk's pairs of the cluster at their
// slots, rays ascending.
__global__ void __launch_bounds__(kPlaceThreads)
    scatter_plan_place_kernel(const unsigned* __restrict__ masks, const int* __restrict__ base,
                              int num_rays, int num_clusters, int cap,
                              long long* __restrict__ items) {
  const int c = blockIdx.y * kPlaceThreads + threadIdx.x;
  if (c >= num_clusters) return;
  const int chunk = blockIdx.x;
  const int row0 = chunk * kWarps;
  const int rows = min(kWarps, (num_rays + 31) / 32 - row0);
  unsigned m[kWarps];
#pragma unroll
  for (int w = 0; w < kWarps; ++w)
    m[w] = w < rows ? masks[static_cast<size_t>(row0 + w) * num_clusters + c] : 0u;
  int slot = base[static_cast<size_t>(chunk) * num_clusters + c];
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    for (unsigned x = m[w]; x != 0u; x &= x - 1u) {
      if (slot >= cap) return;  // this pair and the rest of the run are dropped
      items[slot++] = static_cast<long long>(row0 + w) * 32 + (__ffs(x) - 1);
    }
  }
}

}  // namespace

// The count call: the staged table (L, 8) f32 into `table`, then counts
// (NCH, L) and masks (ceil(R/32), L), NCH = ceil(R / 512) blocks.
// `*launched` gets the kernels launched (2, or 0 when there is no work).
extern "C" int hikari_scatter_plan_count(const float* o, const float* inv, const float* maxd,
                                         const int* lo, const int* hi, const float* cmin,
                                         const float* cmax, const unsigned char* cvalid,
                                         int num_rays, int num_clusters, float* table,
                                         int* counts, unsigned* masks, void* stream,
                                         int* launched) {
  *launched = 0;
  if (num_rays <= 0 || num_clusters <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float4* t = reinterpret_cast<float4*>(table);
  hikari_slab::launch_table<int>(cmin, cmax, cvalid, nullptr, num_clusters, kCluster, t, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  *launched = 1;
  scatter_plan_count_kernel<<<(num_rays + kChunk - 1) / kChunk, kChunk, 0, s>>>(
      o, inv, maxd, lo, hi, t, num_rays, num_clusters, counts, masks);
  err = cudaGetLastError();
  if (err == cudaSuccess) *launched = 2;
  return static_cast<int>(err);
}

// The place call: items written at base + rank, below cap. `*launched`
// gets the kernels launched (1, or 0 when there is no work).
extern "C" int hikari_scatter_plan_place(const unsigned* masks, const int* base, int num_rays,
                                         int num_clusters, int cap, long long* items,
                                         void* stream, int* launched) {
  *launched = 0;
  if (num_rays <= 0 || num_clusters <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((num_rays + kChunk - 1) / kChunk,
                  (num_clusters + kPlaceThreads - 1) / kPlaceThreads);
  scatter_plan_place_kernel<<<grid, kPlaceThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      masks, base, num_rays, num_clusters, cap, items);
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) *launched = 1;
  return static_cast<int>(err);
}

extern "C" const char* hikari_scatter_plan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
