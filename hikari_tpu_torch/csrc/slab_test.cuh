// The ray/cluster-AABB slab test that phase 1 of the tile walk
// (tile_entries.cu) and phases A and B of the scatter tracer
// (scatter_plan.cu) share, for Hopper (sm_90a). Included by both sources;
// utils/nvcc.py hashes this header into each library's name.
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
//     the sign, but the entries are outputs, so both the twin and this
//     test add +0.0 to the entry: -0.0 + 0.0 = +0.0, one rounding that
//     changes nothing else, and every zero entry is +0.0 on every device.
//
// A cluster's validity and its prim range ride in its staged bounds: the
// pair is in range when lo_c < hi and hi_c > lo (the twins' overlap test
// of [c*cluster, (c+1)*cluster) with the ray's [lo, hi)); an invalid
// cluster stages lo_c = the type's largest value and hi_c = its least, so
// neither compare holds for any ray. Phase 1 compares in f32 (the JAX
// package's f32 prim range, exact below 2^24 prims; a ray without a range
// takes (-inf, +inf)), phases A and B in int (scatter.py's int64 test,
// exact while L*128 + 128 < 2^31).

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace hikari_slab {

constexpr float kF32Max = 3.402823466e38f;
constexpr int kBatch = 32;  // clusters staged at once: one per lane of a warp
constexpr unsigned kFull = 0xffffffffu;

// A batch of cluster bounds in shared memory, two 16-byte rows a cluster:
// (min x, min y, min z, max x) and (max y, max z, lo_c, hi_c), lo_c and
// hi_c as the range type's bits.
struct Bounds {
  float4 a[kBatch];
  float4 b[kBatch];
};

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

// One ray's part of the test.
template <typename RangeT>
struct SlabRay {
  float ox, oy, oz, ix, iy, iz, maxd;
  RangeT lo, hi;
};

// Clusters [c0, c0 + nk) into `s`, one a thread (threads 0..nk-1).
template <typename RangeT>
__device__ __forceinline__ void stage_bounds(Bounds& s, const float* __restrict__ cmin,
                                             const float* __restrict__ cmax,
                                             const unsigned char* __restrict__ cvalid, int c0,
                                             int nk, int cluster) {
  using Tr = RangeTraits<RangeT>;
  const int k = threadIdx.x;
  if (k >= nk) return;
  const int c = c0 + k;
  const float* lo = cmin + 3 * static_cast<size_t>(c);
  const float* hi = cmax + 3 * static_cast<size_t>(c);
  RangeT lo_c = Tr::highest(), hi_c = Tr::lowest();
  if (cvalid[c]) {
    lo_c = Tr::of(c * cluster);
    hi_c = Tr::of(c * cluster + cluster);
  }
  s.a[k] = make_float4(lo[0], lo[1], lo[2], hi[0]);
  s.b[k] = make_float4(hi[1], hi[2], Tr::bits(lo_c), Tr::bits(hi_c));
}

// Whether the ray enters the staged cluster (a, b) before its max
// distance, the cluster is valid and its prim range meets the ray's; the
// entry distance, canonical (+0.0 for a zero), in `entry`.
template <typename RangeT>
__device__ __forceinline__ bool slab_hit(const float4& a, const float4& b,
                                         const SlabRay<RangeT>& r, float& entry) {
  using Tr = RangeTraits<RangeT>;
  const float ax = __fmul_rn(__fsub_rn(a.x, r.ox), r.ix);
  const float bx = __fmul_rn(__fsub_rn(a.w, r.ox), r.ix);
  const float ay = __fmul_rn(__fsub_rn(a.y, r.oy), r.iy);
  const float by = __fmul_rn(__fsub_rn(b.x, r.oy), r.iy);
  const float az = __fmul_rn(__fsub_rn(a.z, r.oz), r.iz);
  const float bz = __fmul_rn(__fsub_rn(b.y, r.oz), r.iz);
  const bool nan = (ax != ax) | (bx != bx) | (ay != ay) | (by != by) | (az != az) | (bz != bz);
  const float tlo = fmaxf(fmaxf(fminf(ax, bx), fminf(ay, by)), fminf(az, bz));
  const float thi = fminf(fminf(fmaxf(ax, bx), fmaxf(ay, by)), fmaxf(az, bz));
  entry = __fadd_rn(fmaxf(tlo, 0.f), 0.f);
  const bool in_range = (Tr::value(b.z) < r.hi) & (Tr::value(b.w) > r.lo);
  return !nan & (thi >= entry) & (entry < r.maxd) & in_range;
}

}  // namespace hikari_slab
