// Phase 1 of the tile walk, for Hopper (sm_90a): per tile of 512 rays and
// per cluster the least entry distance into the cluster's AABB over the
// tile's rays, and per ray the largest entry over the clusters it enters.
// Built by hikari_tpu_torch/trace/tiled.py with nvcc into a shared library
// with a plain C interface, loaded with ctypes.
//
// Replaces: hikari_tpu/trace/tiled.py `tile_cluster_entries` (:89-172),
// which `trace_pallas_tiled` (hikari_tpu/trace/pallas_tiled.py:362) and
// `trace_tiled` run before their walks: a slab test of every ray against
// every cluster AABB in (SUB_R, L) sub-blocks under `lax.map`, reduced
// with min over the tile's rays and max over the clusters.
//
// Inputs (the contract of the plain twin `tile_cluster_entries_reference`
// in trace/tiled.py): o, inv (R,3) f32 (inv = safe_inv_dir(d)); maxd (R,)
// f32; with a prim range lo, hi (R,) i32; cmin, cmax (L,3) f32; cvalid
// (L,) bool; R = T * 512. Outputs: entries (T,L) f32, F32_MAX where no ray
// of the tile enters the cluster; ray_maxent (R,) f32, -1 where the ray
// enters none. The slab test and its NaN and signed-zero rules are in
// slab_test.cuh. Entries that enter are never NaN, so the min over the
// tile and the max over the clusters are exact in any order: the result is
// the twin's bit for bit.
//
// What bounds it on this card: operations. Each ray/cluster test is ~30
// FP32 operations (6 subtractions, 6 multiplications, 12 min/max, the
// compares); the bytes (rays, bounds, the (T,L) entries written once) are
// a few MB. At 262,144 rays x 2,153 clusters that is 564 M tests, ~0.25 ms
// at 67 TFLOP/s. The design:
//   - one block per tile, one ray per thread (16 warps); the ray's origin,
//     inverse direction, max distance and range live in registers;
//   - clusters in batches of 32, their bounds staged in shared memory by
//     the first warp (two 16-byte rows a cluster; every lane reads the same
//     row, a broadcast);
//   - per cluster the warp's least entry by shuffles, skipped (one vote)
//     when no lane of the warp enters it; lane k keeps cluster k's, then
//     the first warp takes the least of the 16 warps' from shared memory
//     and writes the batch's 32 entries of the tile;
//   - the per-ray maximum stays in a register and is written once.

#include "slab_test.cuh"

namespace {

using hikari_slab::Bounds;
using hikari_slab::kBatch;
using hikari_slab::kF32Max;
using hikari_slab::kFull;
using hikari_slab::SlabRay;

constexpr int kTileRays = 512;
constexpr int kWarps = kTileRays / 32;

template <bool kRange>
__global__ void __launch_bounds__(kTileRays)
    tile_entries_kernel(const float* __restrict__ o, const float* __restrict__ inv,
                        const float* __restrict__ maxd, const int* __restrict__ lo,
                        const int* __restrict__ hi, const float* __restrict__ cmin,
                        const float* __restrict__ cmax, const unsigned char* __restrict__ cvalid,
                        int num_clusters, int cluster, float* __restrict__ entries,
                        float* __restrict__ ray_maxent) {
  __shared__ Bounds bounds;
  __shared__ float warp_min[kWarps][kBatch];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t ray = static_cast<size_t>(blockIdx.x) * kTileRays + threadIdx.x;
  SlabRay<float> r;
  r.ox = o[3 * ray];
  r.oy = o[3 * ray + 1];
  r.oz = o[3 * ray + 2];
  r.ix = inv[3 * ray];
  r.iy = inv[3 * ray + 1];
  r.iz = inv[3 * ray + 2];
  r.maxd = maxd[ray];
  if (kRange) {  // lo.to(torch.float32), hi.to(torch.float32): round to nearest
    r.lo = __int2float_rn(lo[ray]);
    r.hi = __int2float_rn(hi[ray]);
  } else {
    r.lo = -__int_as_float(0x7f800000);
    r.hi = __int_as_float(0x7f800000);
  }
  float maxent = -1.f;
  float* out = entries + static_cast<size_t>(blockIdx.x) * num_clusters;

  for (int c0 = 0; c0 < num_clusters; c0 += kBatch) {
    const int nk = min(kBatch, num_clusters - c0);
    // Past the last barrier every warp has read the previous batch's bounds
    // and the first warp has read the warps' minima.
    hikari_slab::stage_bounds<float>(bounds, cmin, cmax, cvalid, c0, nk, cluster);
    __syncthreads();
    float mine = kF32Max;  // lane k: the warp's least entry into cluster c0 + k
    for (int k = 0; k < nk; ++k) {
      float entry;
      const bool hit = hikari_slab::slab_hit(bounds.a[k], bounds.b[k], r, entry);
      if (hit) maxent = fmaxf(maxent, entry);
      if (__any_sync(kFull, hit)) {
        float v = hit ? entry : kF32Max;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, off));
        if (lane == k) mine = v;
      }
    }
    warp_min[warp][lane] = mine;
    __syncthreads();
    if (warp == 0 && lane < nk) {
      float m = warp_min[0][lane];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) m = fminf(m, warp_min[w][lane]);
      out[c0 + lane] = m;
    }
  }
  ray_maxent[ray] = maxent;
}

}  // namespace

extern "C" int hikari_tile_entries(const float* o, const float* inv, const float* maxd,
                                   const int* lo, const int* hi, const float* cmin,
                                   const float* cmax, const unsigned char* cvalid, int num_tiles,
                                   int num_clusters, int cluster, int have_range, float* entries,
                                   float* ray_maxent, void* stream) {
  if (num_tiles <= 0 || num_clusters <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (have_range)
    tile_entries_kernel<true><<<num_tiles, kTileRays, 0, s>>>(
        o, inv, maxd, lo, hi, cmin, cmax, cvalid, num_clusters, cluster, entries, ray_maxent);
  else
    tile_entries_kernel<false><<<num_tiles, kTileRays, 0, s>>>(
        o, inv, maxd, lo, hi, cmin, cmax, cvalid, num_clusters, cluster, entries, ray_maxent);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* hikari_tile_entries_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
