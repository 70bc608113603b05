// Closest-hit search of every ray against a triangle table, for Hopper
// (sm_90a). Built by hikari_tpu_torch/trace/closest_hit.py with nvcc into a
// shared library with a plain C interface, loaded with ctypes.
//
// Replaces: hikari_tpu/trace/pallas_kernel.py `_kernel_resident` (K1, the
// whole table resident in VMEM) and `_kernel_streamed` (K1b, the table
// streamed in TRI_TILE blocks with the running best carried across grid
// steps). On the TPU the triangle-tile axis is a sequential grid dimension;
// here it is a loop inside the block over shared-memory tiles, so one kernel
// covers both the resident (<= 2048 triangles) and the streamed case.
//
// Contract (the same as the plain twin `closest_hit_reference` in
// trace/closest_hit.py): for ray r and triangle p in plane/dual-basis form
// (n, eu, ev, cn, cu, cv), t = (cn - o.n) / (d.n), u = (o.eu - cu) + t (d.eu),
// v = (o.ev - cv) + t (d.ev). The pair is accepted iff the triangle is valid,
// |d.n| >= eps, t > eps, u >= 0, v >= 0, u + v <= 1, t < best, t < maxd,
// inst != excl and lo <= p < hi. On a miss t = min(maxd, F32_MAX), prim = -1,
// u = v = 0.
//
// Tie rule, the JAX kernel's: each thread keeps eight running bests, one per
// (prim mod 8) sublane of K1's (8, 128) vreg, and a triangle replaces its
// sublane's best only on a strict `t < best`, so each sublane keeps its
// lowest prim among equal t. On the TPU the streamed K1b carries the eight
// bests across 2,048-triangle tiles; here they live in registers across the
// 256-triangle shared-memory tiles (both tile sizes are multiples of 8, so
// sublane = prim mod 8 in every tile). The final 8 -> 1 step has two modes:
//   lowest_prim = 0 ("pallas", "auto"): the JAX kernel's select tree
//     (pallas_kernel.py `_reduce_sublanes`), halving 8 -> 4 -> 2 -> 1 and
//     taking the upper half only when it is strictly nearer; among equal t
//     the sublanes win in the order 0, 4, 2, 6, 1, 5, 3, 7.
//   lowest_prim = 1 ("bruteforce"): the least t, then the lowest prim of the
//     eight, which is the lowest prim among all equal t: the JAX package's
//     `_trace_bruteforce`.
// A quad's two triangles (2k, 2k + 1) tie on its diagonal; both modes keep
// 2k there.
//
// Bit-for-bit agreement with the twin: every dot product is summed in the
// twin's order ((x*x' + y*y') + z*z') with round-to-nearest intrinsics, so no
// multiply-add is contracted into an FMA whatever the compiler flags (the
// build also passes -fmad=false). t, u, v and prim then equal the twin's.
//
// What bounds it: about 30 flops per ray/triangle pair and no memory traffic
// in the inner loop; the eight bests (t and prim: 16 registers; the winner's
// u, v are recomputed once at the end) lower the occupancy. For cornell (36
// triangles, 2.3 KB) the table fits in shared memory many times over, so a
// 1080p frame's traces are compute-bound and small. Each block of 256 rays
// (one ray per thread) stages the packed (P, 16) table through shared memory
// in tiles of 256 triangles (16 KB) with a barrier between tiles; all
// threads read the same triangle at once, a shared-memory broadcast.
//
// What a later PR should do: double-buffer the tiles with cp.async or TMA,
// and give each thread several rays so a triangle's loads amortise. Big
// scenes do not come here: above 2048 triangles trace/api.py sends rays to
// the cluster walk of tile_walk.cu.

#include <cuda_runtime.h>

namespace {

constexpr int kRaysPerBlock = 256;
constexpr int kTileTris = 256;
constexpr int kRowFloat4 = 4;  // one packed row = 16 floats = 4 float4
constexpr int kSublanes = 8;   // K1's per-sublane bests (the tie rule)
constexpr float kEps = 1.1920929e-7f;
constexpr float kF32Max = 3.402823466e38f;

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx, float by,
                                      float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)), __fmul_rn(az, bz));
}

// Packed row (trace/closest_hit.py pack_triangles):
//   [0] nx ny nz eux  [1] euy euz evx evy  [2] evz cn cu cv
//   [3] valid, inst (int32 bits), pad, pad
__global__ void __launch_bounds__(kRaysPerBlock)
    closest_hit_kernel(const float* __restrict__ o, const float* __restrict__ d,
                       const float* __restrict__ maxd, const int* __restrict__ excl,
                       const int* __restrict__ lo, const int* __restrict__ hi,
                       const float4* __restrict__ tris, int num_tris, int num_rays,
                       int lowest_prim, float* __restrict__ t_out, int* __restrict__ prim_out,
                       float* __restrict__ u_out, float* __restrict__ v_out) {
  __shared__ float4 tile[kTileTris * kRowFloat4];

  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = r < num_rays;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f, md = 0.f;
  int ex = -1, rlo = 0, rhi = 0;
  if (live) {
    ox = o[3 * r];
    oy = o[3 * r + 1];
    oz = o[3 * r + 2];
    dx = d[3 * r];
    dy = d[3 * r + 1];
    dz = d[3 * r + 2];
    md = maxd[r];
    ex = excl[r];
    rlo = lo[r];
    rhi = hi[r];
  }
  // torch.clamp(maxd, max=F32_MAX) semantics: NaN stays NaN (then no pair
  // can pass `t < best`).
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

  for (int base = 0; base < num_tris; base += kTileTris) {
    const int n = min(kTileTris, num_tris - base);
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < n * kRowFloat4; i += blockDim.x) {
      tile[i] = tris[static_cast<size_t>(base) * kRowFloat4 + i];
    }
    __syncthreads();
    if (!live) continue;
    for (int j0 = 0; j0 < n; j0 += kSublanes) {
#pragma unroll
      for (int s = 0; s < kSublanes; ++s) {
        // base is a multiple of 8, so prim mod 8 == s. The last tile's rows
        // j >= n hold stale data: skipped (the same branch in every thread).
        const int j = j0 + s;
        if (j >= n) continue;
        const float4 a = tile[kRowFloat4 * j];
        const float4 b = tile[kRowFloat4 * j + 1];
        const float4 c = tile[kRowFloat4 * j + 2];
        const float4 e = tile[kRowFloat4 * j + 3];
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
        const int prim = base + j;
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
  }
  if (!live) return;
  if (lowest_prim) {
    // The least t, then the lowest prim. A sublane without a hit keeps
    // init_t, which every hit is strictly below, so a miss never ties a hit.
#pragma unroll
    for (int s = 1; s < kSublanes; ++s) {
      if (best_t[s] < best_t[0] || (best_t[s] == best_t[0] && best_p[s] < best_p[0])) {
        best_t[0] = best_t[s];
        best_p[0] = best_p[s];
      }
    }
  } else {
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
}

}  // namespace

extern "C" int hikari_closest_hit(const float* o, const float* d, const float* maxd,
                                  const int* excl, const int* lo, const int* hi,
                                  const float* tris, int num_tris, int num_rays, int lowest_prim,
                                  float* t_out, int* prim_out, float* u_out, float* v_out,
                                  void* stream) {
  if (num_rays <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((num_rays + kRaysPerBlock - 1) / kRaysPerBlock);
  closest_hit_kernel<<<grid, kRaysPerBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      o, d, maxd, excl, lo, hi, reinterpret_cast<const float4*>(tris), num_tris, num_rays,
      lowest_prim, t_out, prim_out, u_out, v_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* hikari_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
