// The ray/triangle pair test that the tile walk (tile_walk.cu, K2) and
// the scatter kernel (scatter_items.cu, K3) share, and the asynchronous
// copies with which both stage rows in shared memory, for Hopper (sm_90a).
// Included by both sources; utils/nvcc.py hashes this header into each
// library's name, so an edit here rebuilds both.
//
// Bit-for-bit agreement with the plain twins: every dot product is summed
// in the twins' order ((x*x' + y*y') + z*z') with round-to-nearest
// intrinsics and the division is __fdiv_rn (the build also passes
// -fmad=false).
//
// What bounds the pair test on this card: issue slots. Under -fmad=false
// nothing fuses, so a pair costs its ~30 multiplies and adds, the ~8
// instructions of the IEEE division, the compares and the shared-memory
// loads. `test_cluster` cuts that count two ways, neither of which changes
// a bit of the result:
//   - when every ray of the warp takes the whole cluster (its prim range
//     covers it), the loop runs without the two range compares;
//   - the sublane bests start at the ray's max distance (or at 0 for an
//     item that is not valid), so `t < best` also carries `t < maxd` and
//     `valid`, which the twins test apart.
// Only the bests' t live in registers. Their keys (which row group holds
// each best) are written to shared memory on the rare replacement, which
// keeps the kernels under 128 registers.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace hikari {

constexpr int kRowFloat4 = 4;  // one packed row = 16 floats = 4 float4
constexpr int kSublanes = 8;   // the JAX kernels' per-sublane bests (the tie rule)
constexpr float kEps = 1.1920929e-7f;
constexpr float kF32Max = 3.402823466e38f;

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx, float by,
                                      float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)), __fmul_rn(az, bz));
}

// One ray's fixed part of the test: origin, direction, the excluded
// instance and its prim range [lo, hi) relative to the tested cluster's
// first prim, clamped at 0 (so no subtraction overflows).
struct Ray {
  float ox, oy, oz, dx, dy, dz;
  int excl, klo, khi;
};

__device__ __forceinline__ void set_range(Ray& r, int lo, int hi, int base) {
  r.klo = lo > base ? lo - base : 0;
  r.khi = hi > base ? hi - base : 0;
}

// The winner's u, v from its row: the pair test's operations on the same
// values, so the same bits as when the test found it.
__device__ __forceinline__ void hit_uv(const Ray& r, float t, const float4* row, float& u,
                                       float& v) {
  const float4 a = row[0], b = row[1], c = row[2];
  const float deu = dot3(r.dx, r.dy, r.dz, a.w, b.x, b.y);
  const float oeu = dot3(r.ox, r.oy, r.oz, a.w, b.x, b.y);
  const float dev = dot3(r.dx, r.dy, r.dz, b.z, b.w, c.x);
  const float oev = dot3(r.ox, r.oy, r.oz, b.z, b.w, c.x);
  u = __fadd_rn(__fsub_rn(oeu, c.z), __fmul_rn(t, deu));
  v = __fadd_rn(__fsub_rn(oev, c.w), __fmul_rn(t, dev));
}

// Packed row (trace/closest_hit.py pack_triangles):
//   [0] nx ny nz eux  [1] euy euz evx evy  [2] evz cn cu cv
//   [3] valid, inst (int32 bits), pad, pad
// Tests the row groups k0 = k_begin, k_begin + k_step, ... < k_end (groups
// of 8 rows) against the thread's ray. Row k = k0 + s goes to sublane s,
// and replaces that sublane's best only on a strict `t < best`: bt[s]
// takes t and key[s * stride] (shared memory) takes key0 + k0, from which
// the caller recovers the prim. kFullRange: the ray's range [klo, khi)
// covers the rows.
template <bool kFullRange>
__device__ __forceinline__ void test_rows(const float4* __restrict__ rows, int k_begin,
                                          int k_end, int k_step, int key0, const Ray& ray,
                                          float (&bt)[kSublanes], int* __restrict__ key,
                                          int stride) {
#pragma unroll 1
  for (int k0 = k_begin; k0 < k_end; k0 += k_step) {
#pragma unroll
    for (int s = 0; s < kSublanes; ++s) {
      const int k = k0 + s;
      const float4 a = rows[kRowFloat4 * k];
      const float4 b = rows[kRowFloat4 * k + 1];
      const float4 c = rows[kRowFloat4 * k + 2];
      const float4 e = rows[kRowFloat4 * k + 3];
      const float dn = dot3(ray.dx, ray.dy, ray.dz, a.x, a.y, a.z);
      const float on = dot3(ray.ox, ray.oy, ray.oz, a.x, a.y, a.z);
      const float adn = fabsf(dn);
      const float t = __fdiv_rn(__fsub_rn(c.y, on), adn < kEps ? 1.0f : dn);
      const float deu = dot3(ray.dx, ray.dy, ray.dz, a.w, b.x, b.y);
      const float oeu = dot3(ray.ox, ray.oy, ray.oz, a.w, b.x, b.y);
      const float dev = dot3(ray.dx, ray.dy, ray.dz, b.z, b.w, c.x);
      const float oev = dot3(ray.ox, ray.oy, ray.oz, b.z, b.w, c.x);
      const float u = __fadd_rn(__fsub_rn(oeu, c.z), __fmul_rn(t, deu));
      const float v = __fadd_rn(__fsub_rn(oev, c.w), __fmul_rn(t, dev));
      const bool ok = (e.x > 0.5f) && (adn >= kEps) && (t > kEps) && (u >= 0.f) &&
                      (v >= 0.f) && (__fadd_rn(u, v) <= 1.f) && (t < bt[s]) &&
                      (__float_as_int(e.y) != ray.excl) &&
                      (kFullRange || ((k >= ray.klo) && (k < ray.khi)));
      if (ok) {
        bt[s] = t;
        key[s * stride] = key0 + k0;
      }
    }
  }
}

// test_rows, without the range compares when no ray of the warp needs
// them. Every lane of the warp must call it with the same rows.
__device__ __forceinline__ void test_cluster(const float4* __restrict__ rows, int k_begin,
                                             int k_end, int k_step, int key0, const Ray& ray,
                                             float (&bt)[kSublanes], int* __restrict__ key,
                                             int stride) {
  if (__all_sync(0xffffffffu, (ray.klo == 0) && (ray.khi >= k_end)))
    test_rows<true>(rows, k_begin, k_end, k_step, key0, ray, bt, key, stride);
  else
    test_rows<false>(rows, k_begin, k_end, k_step, key0, ray, bt, key, stride);
}

// The JAX kernels' final step: halve 8 -> 4 -> 2 -> 1, taking the upper
// half only when it is strictly nearer. Leaves the winner in [0].
__device__ __forceinline__ void halve(float (&bt)[kSublanes], int (&bp)[kSublanes]) {
#pragma unroll
  for (int h = kSublanes / 2; h >= 1; h /= 2) {
#pragma unroll
    for (int s = 0; s < h; ++s) {
      if (bt[s + h] < bt[s]) {
        bt[s] = bt[s + h];
        bp[s] = bp[s + h];
      }
    }
  }
}

// ---- Asynchronous copies global -> shared (cp.async, 16 bytes each) ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One 16-byte chunk from global to shared memory (both 16-byte aligned),
// without waiting. copy_wait() waits for all of this thread's chunks, and
// a __syncthreads() after it makes every thread's chunks visible.
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// The block's threads copy n16 chunks from src to dst, without waiting.
__device__ __forceinline__ void copy_async(float4* dst, const float4* src, int n16) {
  for (int k = threadIdx.x; k < n16; k += blockDim.x) copy16(dst + k, src + k);
}

__device__ __forceinline__ void copy_wait() { asm volatile("cp.async.wait_all;" ::: "memory"); }

}  // namespace hikari
