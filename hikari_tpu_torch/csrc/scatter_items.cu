// Per-item closest hit of the cluster-major scatter tracer, for Hopper
// (sm_90a): every 128-item block tests its items against the 128 triangles
// of its one cluster. Built by hikari_tpu_torch/trace/scatter.py with nvcc
// into a shared library with a plain C interface, loaded with ctypes.
//
// Replaces: hikari_tpu/trace/scatter.py `_make_kernel` -> `_kernel` (K3).
// On the TPU the grid walks the item blocks in order and keeps the last
// cluster's rows resident in VMEM (`resid`), reloading them only when the
// cluster changes; 8 triangles on sublanes meet 128 items on lanes. Here
// one CUDA block of 128 threads takes one item block, one item per thread.
// Blocks run in parallel and in no order, so each block stages its own
// cluster's 128 rows (8 KB) in shared memory with 16-byte loads; every
// thread then reads the same row at once, a shared-memory broadcast.
//
// Inputs (the same contract as the plain twin `scatter_items_reference` in
// trace/scatter.py): meta (NB,2) i32 — per block its cluster id and valid
// item count —; the item fields (11, NB*128) f32, rows o(3) d(3) maxd, then
// excl, lo, hi as int32 bits, then valid (0/1); the packed rows
// (L*128, 16) of trace/closest_hit.py pack_triangles in cluster order.
// Outputs per item t, prim, u, v. A block with count 0 writes misses:
// t = F32_MAX, prim = -1, u = v = 0; so does an item that hits nothing.
//
// The pair test is K1's (pallas_kernel.py / scatter.py:142-166): t < best,
// t < maxd, inst != excl, lo <= prim < hi, item and triangle valid.
//
// Tie rule: the JAX kernel's, copied on purpose. Triangle j goes to
// sublane j mod 8; each sublane keeps its first minimum (strict `<`, so its
// lowest prim); the eight bests are halved 8 -> 4 -> 2 -> 1, taking the
// upper half only when it is strictly nearer (scatter.py:182-194). Among
// equal t the sublanes win in the order 0, 4, 2, 6, 1, 5, 3, 7. This
// differs from K1 and K2 in the port (closest_hit.cu, tile_walk.cu), which
// keep the lowest prim (ROADMAP.md section 3).
//
// Bit-for-bit agreement with the twin: every dot product is summed in the
// twin's order ((x*x' + y*y') + z*z') with round-to-nearest intrinsics,
// the division is __fdiv_rn, and the build passes -fmad=false.
//
// What bounds it: about 30 flops per item/triangle pair (used blocks x 128
// x 128 pairs) at 67 TFLOP/s FP32, against the bytes of each item slot's
// 11 fields read and 4 results written (15 x 4 B x CAP) plus 128 rows of
// 64 B per used block. With ~30 pairs of work per byte it is
// compute-bound. This first version copies the rows with a barrier and
// then tests them, one item per thread; double-buffering the rows with
// cp.async (a persistent block walking consecutive blocks of one cluster
// keeps them resident, as the TPU does) and several items per thread are
// later work.

#include <cuda_runtime.h>

namespace {

constexpr int kBlockItems = 128;
constexpr int kCluster = 128;
constexpr int kSublanes = 8;
constexpr int kRowFloat4 = 4;  // one packed row = 16 floats = 4 float4
constexpr int kFields = 11;
constexpr float kEps = 1.1920929e-7f;
constexpr float kF32Max = 3.402823466e38f;

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx, float by,
                                      float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)), __fmul_rn(az, bz));
}

// Packed row (trace/closest_hit.py pack_triangles):
//   [0] nx ny nz eux  [1] euy euz evx evy  [2] evz cn cu cv
//   [3] valid, inst (int32 bits), pad, pad
__global__ void __launch_bounds__(kBlockItems)
    scatter_items_kernel(const int* __restrict__ meta, const float* __restrict__ fields,
                         const float4* __restrict__ tris, int num_blocks,
                         float* __restrict__ t_out, int* __restrict__ prim_out,
                         float* __restrict__ u_out, float* __restrict__ v_out) {
  __shared__ float4 rows[kCluster * kRowFloat4];

  const int block = blockIdx.x;
  const int item = block * kBlockItems + threadIdx.x;
  const int cid = meta[2 * block];
  const int count = meta[2 * block + 1];
  if (count == 0) {  // the same value in every thread of the block
    t_out[item] = kF32Max;
    prim_out[item] = -1;
    u_out[item] = 0.f;
    v_out[item] = 0.f;
    return;
  }

  const float4* src = tris + static_cast<size_t>(cid) * kCluster * kRowFloat4;
  for (int i = threadIdx.x; i < kCluster * kRowFloat4; i += kBlockItems) rows[i] = src[i];

  const size_t cap = static_cast<size_t>(num_blocks) * kBlockItems;
  float f[kFields];
#pragma unroll
  for (int k = 0; k < kFields; ++k) f[k] = fields[k * cap + item];
  const float ox = f[0], oy = f[1], oz = f[2];
  const float dx = f[3], dy = f[4], dz = f[5];
  const float md = f[6];
  const int ex = __float_as_int(f[7]), rlo = __float_as_int(f[8]), rhi = __float_as_int(f[9]);
  const bool valid = f[10] > 0.5f;
  __syncthreads();

  float best_t[kSublanes], best_u[kSublanes], best_v[kSublanes];
  int best_p[kSublanes];
#pragma unroll
  for (int s = 0; s < kSublanes; ++s) {
    best_t[s] = kF32Max;
    best_p[s] = -1;
    best_u[s] = 0.f;
    best_v[s] = 0.f;
  }

  const int base = cid * kCluster;
  for (int k0 = 0; k0 < kCluster; k0 += kSublanes) {
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
      const bool ok = valid && (e.x > 0.5f) && (fabsf(dn) >= kEps) && (t > kEps) &&
                      (u >= 0.f) && (v >= 0.f) && (__fadd_rn(u, v) <= 1.f) &&
                      (t < best_t[s]) && (t < md) && (__float_as_int(e.y) != ex) &&
                      (prim >= rlo) && (prim < rhi);
      if (ok) {
        best_t[s] = t;
        best_p[s] = prim;
        best_u[s] = u;
        best_v[s] = v;
      }
    }
  }

#pragma unroll
  for (int h = kSublanes / 2; h >= 1; h /= 2) {
#pragma unroll
    for (int s = 0; s < h; ++s) {
      if (best_t[s + h] < best_t[s]) {
        best_t[s] = best_t[s + h];
        best_p[s] = best_p[s + h];
        best_u[s] = best_u[s + h];
        best_v[s] = best_v[s + h];
      }
    }
  }
  t_out[item] = best_t[0];
  prim_out[item] = best_p[0];
  u_out[item] = best_u[0];
  v_out[item] = best_v[0];
}

}  // namespace

extern "C" int hikari_scatter_items(const int* meta, const float* fields, const float* tris,
                                    int num_blocks, int num_clusters, float* t_out,
                                    int* prim_out, float* u_out, float* v_out, void* stream) {
  if (num_blocks <= 0 || num_clusters <= 0) return static_cast<int>(cudaSuccess);
  scatter_items_kernel<<<num_blocks, kBlockItems, 0, static_cast<cudaStream_t>(stream)>>>(
      meta, fields, reinterpret_cast<const float4*>(tris), num_blocks, t_out, prim_out, u_out,
      v_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* hikari_scatter_items_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
