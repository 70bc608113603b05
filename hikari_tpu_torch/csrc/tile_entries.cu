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
// f32; with a prim range lo, hi (R,) i32 and each cluster's prim range
// prange (L,2) i32, within [0, num_prims); cmin, cmax (L,3) f32; cvalid
// (L,) bool; optionally margin (R,) f32, by which each ray grows every box
// (else 0); R = T * 512. Outputs: entries (T,L) f32, F32_MAX where no ray
// of the tile enters the cluster; ray_maxent (R,) f32, -1 where the ray
// enters none. The slab test, the staged table and the NaN and signed-zero
// rules are in slab_test.cuh. Entries that enter are never NaN, so the min
// over the tile and the max over the clusters are exact in any order: the
// result is the twin's bit for bit.
//
// What bounds it on this card: operations. Each ray/cluster test is ~30
// FP32 operations (6 subtractions, 6 multiplications, 11 min/max, the
// compares); the bytes (rays, bounds, the (T,L) entries written once) are
// a few MB. At 262,144 rays x 2,153 clusters that is 564 M tests, ~0.25 ms
// at 67 TFLOP/s. The design:
//   - one block per tile, one ray per thread (16 warps); the ray's origin,
//     inverse direction, max distance and range live in registers;
//   - the call first builds the staged table (slab_table_kernel); the
//     kernel brings it into shared memory kStage clusters at a time,
//     double-buffered by cp.async, behind one barrier a stage; every lane
//     reads the same 32-byte row, a broadcast;
//   - per warp a vote whether all its rays are clean, whether all take
//     every cluster's range and whether all share one octant: the test
//     without NaN compares, without range compares and without the
//     per-axis min and max, where they cannot matter (slab_test.cuh);
//   - per test the entry as the signed-int max of tlo's bits and 0 (the
//     canonical +0.0 for every zero) and one vote; where a ray of the warp
//     enters, the warp's least entry in one __reduce_min_sync on the u32
//     bits (F32_MAX for a ray that misses): entries that enter are
//     non-negative and never NaN, +0.0 canonical, and non-negative floats
//     order as their bits. Lane 0 stores it into the warp's row of the
//     stage in shared memory (F32_MAX where no ray enters); behind the next
//     stage's barrier thread k takes the least of the 16 warps' and writes
//     entry k of the tile;
//   - the per-ray maximum stays in a register and is written once.

#include "slab_test.cuh"

namespace {

using hikari_slab::kF32MaxBits;
using hikari_slab::kFull;
using hikari_slab::kStage;
using hikari_slab::SlabRay;

constexpr int kTileRays = 512;
constexpr int kWarps = kTileRays / 32;

// The tests of one stage for one warp in the form kMode (slab_test.cuh
// warp_mode): the bits of the warp's least entry into cluster k into
// wmin[k], which holds F32_MAX's bits where no ray of the warp enters.
template <int kMode>
__device__ __forceinline__ void entry_stage(const float4* rows, int nk, const SlabRay<float>& r,
                                            unsigned* wmin, bool lane0, float& maxent) {
#pragma unroll 4
  for (int k = 0; k < nk; ++k) {
    float tlo, thi;
    bool ok;
    hikari_slab::slab<kMode>(rows[2 * k], rows[2 * k + 1], r, tlo, thi, ok);
    // max(tlo, 0) with every zero +0.0 (tlo is not NaN where it counts).
    const unsigned bits = static_cast<unsigned>(max(__float_as_int(tlo), 0));
    const float entry = __uint_as_float(bits);
    const bool hit = ok & (thi >= entry) & (entry < r.maxd);
    if (__any_sync(kFull, hit)) {  // most clusters: no ray of the warp enters
      if (hit) maxent = fmaxf(maxent, entry);
      const unsigned v = __reduce_min_sync(kFull, hit ? bits : kF32MaxBits);
      if (lane0) wmin[k] = v;
    }
  }
}

__global__ void __launch_bounds__(kTileRays)
    tile_entries_kernel(const float* __restrict__ o, const float* __restrict__ inv,
                        const float* __restrict__ margin, const float* __restrict__ maxd,
                        const int* __restrict__ lo,
                        const int* __restrict__ hi, const float4* __restrict__ table,
                        int num_clusters, int full_lo, int full_hi, float* __restrict__ entries,
                        float* __restrict__ ray_maxent) {
  __shared__ __align__(16) float4 rows[2][2 * kStage];
  __shared__ unsigned wmin[2][kWarps][kStage];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t ray = static_cast<size_t>(blockIdx.x) * kTileRays + threadIdx.x;
  SlabRay<float> r;
  r.lx = r.hx = o[3 * ray];
  r.ly = r.hy = o[3 * ray + 1];
  r.lz = r.hz = o[3 * ray + 2];
  if (margin != nullptr) {  // o + m for the lower bounds, o - m for the upper
    const float m = margin[ray];
    r.lx = __fadd_rn(r.hx, m);
    r.ly = __fadd_rn(r.hy, m);
    r.lz = __fadd_rn(r.hz, m);
    r.hx = __fsub_rn(r.hx, m);
    r.hy = __fsub_rn(r.hy, m);
    r.hz = __fsub_rn(r.hz, m);
  }
  r.ix = inv[3 * ray];
  r.iy = inv[3 * ray + 1];
  r.iz = inv[3 * ray + 2];
  r.maxd = maxd[ray];
  if (lo != nullptr) {  // lo.to(torch.float32), hi.to(torch.float32): round to nearest
    r.lo = __int2float_rn(lo[ray]);
    r.hi = __int2float_rn(hi[ray]);
  } else {
    r.lo = -__int_as_float(0x7f800000);
    r.hi = __int_as_float(0x7f800000);
  }
  const int mode = hikari_slab::warp_mode(r, full_lo, full_hi);
  const bool lane0 = lane == 0;
  float maxent = -1.f;
  float* out = entries + static_cast<size_t>(blockIdx.x) * num_clusters;
  const int stages = (num_clusters + kStage - 1) / kStage;

  hikari_slab::copy_stage(rows[0], table, 0, num_clusters);
  for (int s = 0; s <= stages; ++s) {
    hikari_slab::wait_copies();
    // Past this barrier stage s is in rows[s & 1], every warp is done with
    // stage s - 1's rows and has stored its minima of stage s - 1.
    __syncthreads();
    if (s + 1 < stages) hikari_slab::copy_stage(rows[(s + 1) & 1], table, s + 1, num_clusters);
    if (s > 0) {  // the entries of stage s - 1
      const int c0 = (s - 1) * kStage, nk = min(kStage, num_clusters - c0);
      if (threadIdx.x < nk) {
        unsigned m = wmin[(s - 1) & 1][0][threadIdx.x];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) m = min(m, wmin[(s - 1) & 1][w][threadIdx.x]);
        out[c0 + threadIdx.x] = __uint_as_float(m);
      }
    }
    if (s == stages) break;
    const int nk = min(kStage, num_clusters - s * kStage);
    unsigned* wm = wmin[s & 1][warp];
    const float4* rs = rows[s & 1];
    for (int k = lane; k < nk; k += 32) wm[k] = kF32MaxBits;  // a warp no ray enters
    __syncwarp();
    hikari_slab::with_mode(mode, [&](auto m) {
      entry_stage<decltype(m)::value>(rs, nk, r, wm, lane0, maxent);
    });
  }
  ray_maxent[ray] = maxent;
}

}  // namespace

// The staged table (L, 8) f32 into `table`, then the entries (T, L) and
// the max entries (R,), one block a tile. lo, hi and prange are null
// together (no range: every ray takes (-inf, inf), which holds the staged
// [0, 0) of every cluster), and margin may be (no margin). A warp whose rays
// all have lo < 1 and hi > num_prims - 1 takes every cluster's range.
// `*launched` gets the kernels launched (2, or 0 when there is no work).
extern "C" int hikari_tile_entries(const float* o, const float* inv, const float* margin,
                                   const float* maxd,
                                   const int* lo, const int* hi, const float* cmin,
                                   const float* cmax, const unsigned char* cvalid,
                                   const int* prange, int num_tiles, int num_clusters,
                                   int num_prims, float* table, float* entries,
                                   float* ray_maxent, void* stream, int* launched) {
  *launched = 0;
  if (num_tiles <= 0 || num_clusters <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float4* t = reinterpret_cast<float4*>(table);
  hikari_slab::launch_table<float>(cmin, cmax, cvalid, prange, num_clusters, 0, t, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  *launched = 1;
  tile_entries_kernel<<<num_tiles, kTileRays, 0, s>>>(o, inv, margin, maxd, lo, hi, t,
                                                       num_clusters, 1, num_prims - 1, entries,
                                                       ray_maxent);
  err = cudaGetLastError();
  if (err == cudaSuccess) *launched = 2;
  return static_cast<int>(err);
}

extern "C" const char* hikari_tile_entries_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
