// Tile walk of the large-scene tracer, for Hopper (sm_90a): each 512-ray
// tile walks its own list of triangle clusters near to far and retires
// early. Built by hikari_tpu_torch/trace/tile_walk.py with nvcc into a
// shared library with a plain C interface, loaded with ctypes.
//
// Replaces: hikari_tpu/trace/pallas_tiled.py `_make_kernel` -> `_kernel`
// (K2). On the TPU one grid step walks one tile in a `while_loop`, the
// cluster rows double-buffered HBM->VMEM by async DMA, 8 triangles on
// sublanes against the tile's rays on lanes. Here one block of 512 threads
// walks one tile, one ray per thread, and stages each cluster's rows in
// shared memory (cluster x 64 B: 16 KB at cluster 256) before all threads
// test it; every thread reads the same row at once, a shared-memory
// broadcast. Blocks run in parallel and in no order; nothing is carried
// between them.
//
// Inputs (the same contract as the plain twin `tile_walk_reference` in
// trace/tile_walk.py), R = T * 512 rays sorted into tiles by the caller:
// per ray o, d (R,3), maxd, early, maxent (R,) f32 and excl, lo, hi (R,)
// i32; per tile the cluster ids `order` (T,L) i32 in ascending phase-1
// entry distance and those distances `entry` (T,L) f32; the packed rows
// (L*cluster, 16) of trace/closest_hit.py pack_triangles in cluster order,
// and the cluster AABBs cmin, cmax (L,3).
//
// Walk of one tile (pallas_tiled.py:224-302). It starts unless entry[0] is
// F32_MAX. At step j, for cluster c = order[j]:
//   1. with the skip on, re-test c's AABB against every ray's CURRENT best
//      (the least of its eight sublane bests; slab test with the
//      signed-epsilon inverse direction); the block votes with
//      __syncthreads_or and tests c only if some ray enters;
//   2. dense-test the cluster's triangles against every ray of the tile:
//      K1's pair test with t < best, t < maxd, inst != excl and
//      lo <= prim < hi;
//   3. retire the tile when j+1 == L, or entry[j+1] is F32_MAX, or no ray
//      is still open: a ray is open when it is not done early (some
//      sublane holds a hit nearer than early), its least best >
//      entry[j+1] and maxent >= entry[j+1]. The block votes with
//      __syncthreads_or.
// Outputs per ray t, prim, u, v (a miss: t = min(maxd, F32_MAX), prim -1,
// u = v = 0) and per tile the number of clusters tested.
//
// Tie rule, the JAX kernel's (pallas_tiled.py:161-216, :309-326): each
// thread keeps eight running bests over the whole walk, one per (row mod 8)
// sublane of a cluster (clusters are multiples of 8 rows, so the sublane is
// also prim mod 8), each replaced only on a strict `t < best`. At the end
// the eight are halved 8 -> 4 -> 2 -> 1, taking the upper half only when
// it is strictly nearer: among equal t the sublanes win in the order
// 0, 4, 2, 6, 1, 5, 3, 7, whichever clusters the triangles lie in.
//
// Bit-for-bit agreement with the twin: every dot product is summed in the
// twin's order ((x*x' + y*y') + z*z') with round-to-nearest intrinsics and
// the divisions are __fdiv_rn (the build also passes -fmad=false), the
// slab test's min/max propagate NaN as torch.minimum/maximum do. t, u, v,
// prim and the per-tile counts then equal the twin's.
//
// What bounds it: about 30 flops per tested ray/triangle pair (tested
// clusters x 512 x cluster pairs) at 67 TFLOP/s FP32 (the eight bests cost
// 16 registers and a few compares per cluster; the winner's u, v are
// recomputed once at the end), and the tested
// clusters' rows, cluster x 64 B each, from L2 or HBM (the city's table is
// 35 MB and fits in the 50 MB L2). The pair test dominates: it is
// compute-bound. This first version copies a cluster with a barrier and
// then tests it; a later PR should double-buffer the rows with cp.async,
// give each thread several rays, and fuse phase 1 (trace/tiled.py).

#include <cuda_runtime.h>

namespace {

constexpr int kTileRays = 512;
constexpr int kRowFloat4 = 4;  // one packed row = 16 floats = 4 float4
constexpr int kSublanes = 8;   // K2's per-sublane bests (the tie rule)
constexpr float kEps = 1.1920929e-7f;
constexpr float kF32Max = 3.402823466e38f;

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx, float by,
                                      float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)), __fmul_rn(az, bz));
}

// torch.minimum / torch.maximum: NaN if either operand is NaN.
__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// The least of the eight bests, NaN if any is NaN (jnp.min, torch.amin).
__device__ __forceinline__ float least(const float (&t)[kSublanes]) {
  float m = t[0];
#pragma unroll
  for (int s = 1; s < kSublanes; ++s) m = nan_min(m, t[s]);
  return m;
}

// trace/tiled.py safe_inv_dir: 1/d with a signed epsilon floor.
__device__ __forceinline__ float safe_inv(float x) {
  const float s = fabsf(x) < 1e-20f ? (x < 0.f ? -1e-20f : 1e-20f) : x;
  return __fdiv_rn(1.0f, s);
}

// Packed row (trace/closest_hit.py pack_triangles):
//   [0] nx ny nz eux  [1] euy euz evx evy  [2] evz cn cu cv
//   [3] valid, inst (int32 bits), pad, pad
__global__ void __launch_bounds__(kTileRays)
    tile_walk_kernel(const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ maxd, const float* __restrict__ early,
                     const int* __restrict__ excl, const int* __restrict__ lo,
                     const int* __restrict__ hi, const float* __restrict__ maxent,
                     const int* __restrict__ order, const float* __restrict__ entry,
                     const float4* __restrict__ tris, const float* __restrict__ cmin,
                     const float* __restrict__ cmax, int num_clusters, int cluster,
                     int use_skip, float* __restrict__ t_out, int* __restrict__ prim_out,
                     float* __restrict__ u_out, float* __restrict__ v_out,
                     int* __restrict__ tested_out) {
  extern __shared__ float4 rows[];  // cluster * kRowFloat4

  const int tile = blockIdx.x;
  const int r = tile * kTileRays + threadIdx.x;
  const float ox = o[3 * r], oy = o[3 * r + 1], oz = o[3 * r + 2];
  const float dx = d[3 * r], dy = d[3 * r + 1], dz = d[3 * r + 2];
  const float md = maxd[r], ea = early[r], me = maxent[r];
  const int ex = excl[r], rlo = lo[r], rhi = hi[r];
  const float ix = safe_inv(dx), iy = safe_inv(dy), iz = safe_inv(dz);

  // torch.clamp(maxd, max=F32_MAX) semantics: NaN stays NaN.
  const float init_t = isnan(md) ? md : fminf(md, kF32Max);
  // u and v are not kept per sublane: they are recomputed for the winner
  // at the end (the same operations on the same values give the same bits),
  // which saves 16 registers.
  float best_t[kSublanes];
  int best_p[kSublanes];
#pragma unroll
  for (int s = 0; s < kSublanes; ++s) {
    best_t[s] = init_t;
    best_p[s] = -1;
  }

  const int L = num_clusters;
  const int* ord = order + static_cast<size_t>(tile) * L;
  const float* ent = entry + static_cast<size_t>(tile) * L;
  int tested = 0;
  bool walk = ent[0] < kF32Max;  // the same value in every thread

  for (int j = 0; walk; ++j) {
    const int cid = ord[j];
    bool test = true;
    if (use_skip) {
      const float* bmin = cmin + 3 * cid;
      const float* bmax = cmax + 3 * cid;
      const float ax = __fmul_rn(__fsub_rn(bmin[0], ox), ix);
      const float bx = __fmul_rn(__fsub_rn(bmax[0], ox), ix);
      const float ay = __fmul_rn(__fsub_rn(bmin[1], oy), iy);
      const float by = __fmul_rn(__fsub_rn(bmax[1], oy), iy);
      const float az = __fmul_rn(__fsub_rn(bmin[2], oz), iz);
      const float bz = __fmul_rn(__fsub_rn(bmax[2], oz), iz);
      const float tlo = nan_max(nan_max(nan_min(ax, bx), nan_min(ay, by)), nan_min(az, bz));
      const float thi = nan_min(nan_min(nan_max(ax, bx), nan_max(ay, by)), nan_max(az, bz));
      const float box_entry = nan_max(tlo, 0.f);
      const float bt_now = least(best_t);
      const bool enters = (thi >= box_entry) && (box_entry < bt_now) && (box_entry < md);
      test = __syncthreads_or(enters) != 0;
    }
    if (test) {
      // The previous cluster's rows are no longer read: every thread has
      // passed the retirement vote (a barrier) since its test loop.
      const float4* src = tris + static_cast<size_t>(cid) * cluster * kRowFloat4;
      for (int i = threadIdx.x; i < cluster * kRowFloat4; i += blockDim.x) rows[i] = src[i];
      __syncthreads();
      const int base = cid * cluster;
      for (int k0 = 0; k0 < cluster; k0 += kSublanes) {
#pragma unroll
        for (int s = 0; s < kSublanes; ++s) {
          const int k = k0 + s;
          const float4 a = rows[kRowFloat4 * k];
          const float4 b = rows[kRowFloat4 * k + 1];
          const float4 c = rows[kRowFloat4 * k + 2];
          const float4 e = rows[kRowFloat4 * k + 3];
          const float dn = dot3(dx, dy, dz, a.x, a.y, a.z);
          const float on = dot3(ox, oy, oz, a.x, a.y, a.z);
          const float safe_dn = fabsf(dn) < kEps ? 1.0f : dn;
          const float t = __fdiv_rn(__fsub_rn(c.y, on), safe_dn);
          const float deu = dot3(dx, dy, dz, a.w, b.x, b.y);
          const float oeu = dot3(ox, oy, oz, a.w, b.x, b.y);
          const float dev = dot3(dx, dy, dz, b.z, b.w, c.x);
          const float oev = dot3(ox, oy, oz, b.z, b.w, c.x);
          const float u = __fadd_rn(__fsub_rn(oeu, c.z), __fmul_rn(t, deu));
          const float v = __fadd_rn(__fsub_rn(oev, c.w), __fmul_rn(t, dev));
          const int prim = base + k;
          const bool ok = (e.x > 0.5f) && (fabsf(dn) >= kEps) && (t > kEps) && (u >= 0.f) &&
                          (v >= 0.f) && (__fadd_rn(u, v) <= 1.f) && (t < best_t[s]) &&
                          (t < md) && (__float_as_int(e.y) != ex) && (prim >= rlo) &&
                          (prim < rhi);
          if (ok) {
            best_t[s] = t;
            best_p[s] = prim;
          }
        }
      }
      ++tested;
    }
    const float e_next = ent[min(j + 1, L - 1)];
    bool done_early = false;
#pragma unroll
    for (int s = 0; s < kSublanes; ++s) done_early |= (best_p[s] >= 0) && (best_t[s] < ea);
    const bool open = !done_early && (least(best_t) > e_next) && (me >= e_next);
    const int any_open = __syncthreads_or(open);
    walk = (j + 1 < L) && (e_next < kF32Max) && any_open;
  }

#pragma unroll
  for (int h = kSublanes / 2; h >= 1; h /= 2) {
#pragma unroll
    for (int s = 0; s < h; ++s) {
      if (best_t[s + h] < best_t[s]) {
        best_t[s] = best_t[s + h];
        best_p[s] = best_p[s + h];
      }
    }
  }
  float best_u = 0.f, best_v = 0.f;
  if (best_p[0] >= 0) {
    const float4* row = tris + static_cast<size_t>(best_p[0]) * kRowFloat4;
    const float4 a = row[0], b = row[1], c = row[2];
    const float t = best_t[0];
    const float deu = dot3(dx, dy, dz, a.w, b.x, b.y);
    const float oeu = dot3(ox, oy, oz, a.w, b.x, b.y);
    const float dev = dot3(dx, dy, dz, b.z, b.w, c.x);
    const float oev = dot3(ox, oy, oz, b.z, b.w, c.x);
    best_u = __fadd_rn(__fsub_rn(oeu, c.z), __fmul_rn(t, deu));
    best_v = __fadd_rn(__fsub_rn(oev, c.w), __fmul_rn(t, dev));
  }
  t_out[r] = best_t[0];
  prim_out[r] = best_p[0];
  u_out[r] = best_u;
  v_out[r] = best_v;
  if (threadIdx.x == 0) tested_out[tile] = tested;
}

}  // namespace

extern "C" int hikari_tile_walk(const float* o, const float* d, const float* maxd,
                                const float* early, const int* excl, const int* lo,
                                const int* hi, const float* maxent, const int* order,
                                const float* entry, const float* tris, const float* cmin,
                                const float* cmax, int num_tiles, int num_clusters, int cluster,
                                int use_skip, float* t_out, int* prim_out, float* u_out,
                                float* v_out, int* tested_out, void* stream) {
  if (num_tiles <= 0) return static_cast<int>(cudaSuccess);
  const int smem = cluster * kRowFloat4 * static_cast<int>(sizeof(float4));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tile_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  tile_walk_kernel<<<num_tiles, kTileRays, smem, static_cast<cudaStream_t>(stream)>>>(
      o, d, maxd, early, excl, lo, hi, maxent, order, entry,
      reinterpret_cast<const float4*>(tris), cmin, cmax, num_clusters, cluster, use_skip, t_out,
      prim_out, u_out, v_out, tested_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* hikari_tile_walk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
