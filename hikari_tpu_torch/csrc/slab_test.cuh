// The ray/cluster-AABB slab test that phase 1 of the tile walk
// (tile_entries.cu) and phase A of the scatter tracer (scatter_plan.cu)
// share, for Hopper (sm_90a). Included by both sources; utils/nvcc.py
// hashes this header into each library's name.
//
// Bit-for-bit agreement with the plain twins (trace/tiled.py
// tile_cluster_entries_reference, trace/scatter.py _chunk_mask):
//   - per axis a = (cmin - o) * inv and b = (cmax - o) * inv, a subtraction
//     and then a multiplication, each rounded (__fsub_rn, __fmul_rn; the
//     build passes -fmad=false);
//   - tlo = max over the axes of min(a, b), thi = min over the axes of
//     max(a, b), entry = max(tlo, 0). torch.minimum, torch.maximum, amin,
//     amax and clamp propagate NaN, where fminf and fmaxf drop it. A NaN
//     among the six products makes tlo or thi NaN in the twin, and every
//     compare with NaN is false, so the twin's pair misses: here a NaN
//     among the six products makes the pair miss, and without one the
//     NaN-dropping fminf/fmaxf give the twin's values;
//   - the sign of a zero entry: a ray whose origin lies on a cluster's max
//     face with a negative direction gives (cmax - o) * inv = 0 * inv =
//     -0.0, and torch's min, max and clamp return either zero by operand
//     order (on the CPU, clamp(-0.0, min=0) is -0.0). Compares do not see
//     the sign, but phase 1's entries are outputs, so its twin adds +0.0 to
//     the entry (-0.0 + 0.0 = +0.0, one rounding that changes nothing
//     else) and phase 1 here takes the entry as the signed-int max of
//     tlo's bits and 0: the same value for every tlo that is not NaN, and
//     +0.0 for every zero or negative tlo. Phase A outputs no entry and
//     needs neither.
//
// Where no NaN can arise the NaN compares are skipped. Under safe_inv_dir
// (a floor of 1e-20 on |d|) inv is NaN only for a NaN d and 0 only for an
// infinite d. For a "clean" ray, whose o and inv are finite and whose inv
// has no zero component, cmin - o is NaN only for a NaN bound (an overflow
// gives +-inf, never NaN), and +-inf or a finite value times a finite
// nonzero inv is never NaN. A cluster with a NaN bound has a NaN product
// on that axis for every ray, so the twin never enters it: the table below
// stages it as invalid. So a pair of a clean ray and a staged cluster has
// no NaN product, and a warp whose 32 rays are all clean (one vote a call)
// runs the test without the NaN compares; any other warp runs them.
//
// A warp whose clean rays take every cluster's range and share one octant
// (the signs of inv) skips the per-axis min and max too: the table stores
// each axis's bounds in order (lo = min(cmin, cmax), hi = max: min(a, b)
// and max(a, b) do not see which is which, so no result changes), and
// with lo <= hi the rounded (lo - o) * inv <= (hi - o) * inv where inv > 0
// (>= where inv < 0), so the near bound is known per axis: tlo = max of
// the three near products, thi = min of the three far ones (equal
// products are equal in value, and a zero's sign reaches no result).
//
// A cluster's validity and its prim range ride in its staged row: the pair
// is in range when lo_c < hi and hi_c > lo (the twins' overlap test of the
// cluster's own [lo, hi) from `prange` in phase 1, where the rows may come
// in any order, or of [c*cluster, (c+1)*cluster) in phase A, whose clusters
// are in prim order, with the ray's [lo, hi)); an invalid cluster
// stages lo_c = the type's largest value and hi_c = its least, so neither
// compare holds for any ray. Phase 1 compares in f32 (the JAX package's f32
// prim range, exact below 2^24 prims; a ray without a range takes (-inf,
// +inf)), phase A in int (scatter.py's int64 test, exact while L*128 + 128
// < 2^31). An invalid cluster also stages +inf for all six bounds, which a
// clean ray never enters (on each axis a = b = +-inf: tlo = +inf, which no
// max distance exceeds, or thi = -inf, below any entry). So a warp whose
// rays all take every cluster's range (lo < full_lo and hi > full_hi, which
// the caller sets so that they imply it: (1, num_prims - 1) in phase 1,
// (cluster, (L - 1) * cluster) in phase A; one more vote) skips the range
// compares too.
//
// Staging: the wrapper's call first builds the (L, 8) f32 table once
// (slab_table_kernel, one thread a cluster): (lo x, lo y, lo z, hi x) and
// (hi y, hi z, lo_c, hi_c), lo_c and hi_c as the range type's bits.
// The test kernels bring it into shared memory kStage clusters at a time
// with cp.async into two buffers, so that the copy of the next stage runs
// under the tests of this one, behind one barrier a stage.

#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace hikari_slab {

constexpr unsigned kF32MaxBits = 0x7f7fffffu;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kStage = 128;  // clusters staged at once
constexpr int kTableThreads = 256;

template <typename RangeT>
struct RangeTraits;
template <>
struct RangeTraits<float> {
  __device__ static float bits(float x) { return x; }
  __device__ static float value(float x) { return x; }
  __device__ static float lowest() { return -__int_as_float(0x7f800000); }
  __device__ static float highest() { return __int_as_float(0x7f800000); }
  // The twin's f32 cluster range: c*cluster and c*cluster + cluster, both
  // exact below 2^24.
  __device__ static float of(int first) { return static_cast<float>(first); }
};
template <>
struct RangeTraits<int> {
  __device__ static float bits(int x) { return __int_as_float(x); }
  __device__ static int value(float x) { return __float_as_int(x); }
  __device__ static int lowest() { return INT32_MIN; }
  __device__ static int highest() { return INT32_MAX; }
  __device__ static int of(int first) { return first; }
};

// The staged table: row 2c and 2c + 1 of cluster c, as described above.
template <typename RangeT>
__global__ void __launch_bounds__(kTableThreads)
    slab_table_kernel(const float* __restrict__ cmin, const float* __restrict__ cmax,
                      const unsigned char* __restrict__ cvalid, const int* __restrict__ prange,
                      int num_clusters, int cluster, float4* __restrict__ table) {
  using Tr = RangeTraits<RangeT>;
  const int c = blockIdx.x * kTableThreads + threadIdx.x;
  if (c >= num_clusters) return;
  float v[6];
  bool nan = false;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    v[i] = cmin[3 * static_cast<size_t>(c) + i];
    v[3 + i] = cmax[3 * static_cast<size_t>(c) + i];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) nan |= v[i] != v[i];
  if (cvalid[c] && !nan) {
    const float lx = fminf(v[0], v[3]), ly = fminf(v[1], v[4]), lz = fminf(v[2], v[5]);
    const float hx = fmaxf(v[0], v[3]), hy = fmaxf(v[1], v[4]), hz = fmaxf(v[2], v[5]);
    table[2 * static_cast<size_t>(c)] = make_float4(lx, ly, lz, hx);
    table[2 * static_cast<size_t>(c) + 1] =
        prange != nullptr
            ? make_float4(hy, hz, Tr::bits(Tr::of(prange[2 * static_cast<size_t>(c)])),
                          Tr::bits(Tr::of(prange[2 * static_cast<size_t>(c) + 1])))
            : make_float4(hy, hz, Tr::bits(Tr::of(c * cluster)),
                          Tr::bits(Tr::of(c * cluster + cluster)));
  } else {
    const float inf = __int_as_float(0x7f800000);
    table[2 * static_cast<size_t>(c)] = make_float4(inf, inf, inf, inf);
    table[2 * static_cast<size_t>(c) + 1] =
        make_float4(inf, inf, Tr::bits(Tr::highest()), Tr::bits(Tr::lowest()));
  }
}

template <typename RangeT>
inline void launch_table(const float* cmin, const float* cmax, const unsigned char* cvalid,
                         const int* prange, int num_clusters, int cluster, float4* table,
                         cudaStream_t s) {
  slab_table_kernel<RangeT><<<(num_clusters + kTableThreads - 1) / kTableThreads, kTableThreads,
                              0, s>>>(cmin, cmax, cvalid, prange, num_clusters, cluster, table);
}

// One ray's part of the test. The lower bounds are taken from the origin
// (lx, ly, lz) and the upper ones from (hx, hy, hz): both the ray's origin,
// or o + m and o - m where the ray grows every box by a margin m (phase 1
// of the tile walk: trace/tile_walk.py ray_margin), so that
// a = (lo - (o + m)) * inv and b = (hi - (o - m)) * inv, lo and hi the
// staged bounds in order (a box with cmin > cmax on an axis grows from
// them: the twin takes them in order too). As o + m >= o - m, the rounded
// a <= b still holds where inv > 0 and lo <= hi.
template <typename RangeT>
struct SlabRay {
  float lx, ly, lz, hx, hy, hz, ix, iy, iz, maxd;
  RangeT lo, hi;
};

// Whether no product of this ray with a staged cluster can be NaN.
template <typename RangeT>
__device__ __forceinline__ bool clean(const SlabRay<RangeT>& r) {
  return isfinite(r.lx) & isfinite(r.ly) & isfinite(r.lz) & isfinite(r.hx) & isfinite(r.hy) &
         isfinite(r.hz) & isfinite(r.ix) & isfinite(r.iy) & isfinite(r.iz) & (r.ix != 0.f) &
         (r.iy != 0.f) & (r.iz != 0.f);
}

// Whether the ray's range takes every cluster's.
template <typename RangeT>
__device__ __forceinline__ bool full_range(const SlabRay<RangeT>& r, int full_lo,
                                           int full_hi) {
  using Tr = RangeTraits<RangeT>;
  return (r.lo < Tr::of(full_lo)) & (r.hi > Tr::of(full_hi));
}

// The warp's form of the test: modes 0-7 for clean rays that take every
// range and share octant kMode (bit 0: inv.x < 0, bit 1: y, bit 2: z);
// kCleanFull for clean rays that take every range; kClean for clean rays;
// kAny for any rays.
constexpr int kCleanFull = 8, kClean = 9, kAny = 10;

template <typename RangeT>
__device__ __forceinline__ int warp_mode(const SlabRay<RangeT>& r, int full_lo, int full_hi) {
  if (!__all_sync(kFull, clean(r))) return kAny;
  if (!__all_sync(kFull, full_range(r, full_lo, full_hi))) return kClean;
  const int oct = (r.ix < 0.f) | ((r.iy < 0.f) << 1) | ((r.iz < 0.f) << 2);
  const int oct0 = __shfl_sync(kFull, oct, 0);
  return __all_sync(kFull, oct == oct0) ? oct0 : kCleanFull;
}

// f(std::integral_constant<int, mode>) for the warp's mode (warp-uniform).
template <int M = 0, typename F>
__device__ __forceinline__ void with_mode(int mode, F&& f) {
  if constexpr (M < kAny) {
    if (mode != M) return with_mode<M + 1>(mode, f);
  }
  f(std::integral_constant<int, M>{});
}

// The slab interval (tlo, thi) of the staged cluster (a, b) in the form
// kMode, and whether the pair may enter: no NaN product and the ranges
// meet (each checked only where kMode needs it).
template <int kMode, typename RangeT>
__device__ __forceinline__ void slab(const float4& a, const float4& b, const SlabRay<RangeT>& r,
                                     float& tlo, float& thi, bool& ok) {
  if constexpr (kMode < kCleanFull) {
    constexpr bool sx = kMode & 1, sy = kMode & 2, sz = kMode & 4;
    const float nx = __fmul_rn(sx ? __fsub_rn(a.w, r.hx) : __fsub_rn(a.x, r.lx), r.ix);
    const float fx = __fmul_rn(sx ? __fsub_rn(a.x, r.lx) : __fsub_rn(a.w, r.hx), r.ix);
    const float ny = __fmul_rn(sy ? __fsub_rn(b.x, r.hy) : __fsub_rn(a.y, r.ly), r.iy);
    const float fy = __fmul_rn(sy ? __fsub_rn(a.y, r.ly) : __fsub_rn(b.x, r.hy), r.iy);
    const float nz = __fmul_rn(sz ? __fsub_rn(b.y, r.hz) : __fsub_rn(a.z, r.lz), r.iz);
    const float fz = __fmul_rn(sz ? __fsub_rn(a.z, r.lz) : __fsub_rn(b.y, r.hz), r.iz);
    tlo = fmaxf(fmaxf(nx, ny), nz);
    thi = fminf(fminf(fx, fy), fz);
    ok = true;
  } else {
    const float ax = __fmul_rn(__fsub_rn(a.x, r.lx), r.ix);
    const float bx = __fmul_rn(__fsub_rn(a.w, r.hx), r.ix);
    const float ay = __fmul_rn(__fsub_rn(a.y, r.ly), r.iy);
    const float by = __fmul_rn(__fsub_rn(b.x, r.hy), r.iy);
    const float az = __fmul_rn(__fsub_rn(a.z, r.lz), r.iz);
    const float bz = __fmul_rn(__fsub_rn(b.y, r.hz), r.iz);
    tlo = fmaxf(fmaxf(fminf(ax, bx), fminf(ay, by)), fminf(az, bz));
    thi = fminf(fminf(fmaxf(ax, bx), fmaxf(ay, by)), fmaxf(az, bz));
    ok = true;
    if constexpr (kMode == kAny)
      ok = !((ax != ax) | (bx != bx) | (ay != ay) | (by != by) | (az != az) | (bz != bz));
    if constexpr (kMode != kCleanFull) {
      using Tr = RangeTraits<RangeT>;
      ok &= (Tr::value(b.z) < r.hi) & (Tr::value(b.w) > r.lo);
    }
  }
}

// Stage s of the table (clusters [s*kStage, min(L, (s+1)*kStage))) into
// `dst` by cp.async, 16 bytes a copy, spread over the block's threads;
// one commit group.
__device__ __forceinline__ void copy_stage(float4* dst, const float4* __restrict__ table, int s,
                                           int num_clusters) {
  const int c0 = s * kStage;
  const int n = 2 * min(kStage, num_clusters - c0);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst + i));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(table + 2 * static_cast<size_t>(c0) + i)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// This thread's copies all landed (the block's need a barrier after).
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

}  // namespace hikari_slab
