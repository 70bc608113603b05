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
// Tie rule, the JAX kernel's, with one running best per ray. The JAX kernel
// keeps a best per (prim mod 8) sublane, each replaced only on a strict
// `t < best` over rows in increasing prim order, then halves the eight
// 8 -> 4 -> 2 -> 1, taking the upper half only when it is strictly nearer
// (pallas_kernel.py `_reduce_sublanes`). So its winner is the least key
// (t, rank(prim mod 8), prim), rank being the 3-bit reversal (sublanes win
// in the order 0, 4, 2, 6, 1, 5, 3, 7), and a single best that takes a pair
// when its key is less gives the same bits. "bruteforce" (the JAX
// `_trace_bruteforce`) is the key (t, prim): the rank is a constant there.
//
// Bit-for-bit agreement with the twin: every dot product is summed in the
// twin's order ((x*x' + y*y') + z*z') with round-to-nearest intrinsics, so no
// multiply-add is contracted into an FMA whatever the compiler flags (the
// build also passes -fmad=false). t, u, v and prim then equal the twin's.
//
// What bounds it on this card: issue slots per ray/triangle pair (the ~30
// unfused flops, the IEEE division, the compares and four shared-memory
// loads: ~60 SASS instructions on the loop's common path, counted by
// tools/ab_trace_kernels.py [sass]); the rays' bytes take a fifth of that
// at 1080p against cornell. The design cuts what a pair costs and the
// pairs tested, none of which changes a bit:
//   - one best (t, prim, rank) instead of eight: the loop tests `t <= best`
//     and resolves a tie only in the rarely taken branch, which the
//     compiler keeps out of the common path with the instance load and the
//     update; the freed registers (73 -> ~54) raise the resident warps;
//   - the best starts at min(maxd, F32_MAX), so `t < best` carries
//     `t < maxd`; a ray that can take no row (an empty prim range, a max
//     distance not above eps or NaN) starts at 0 and takes nothing;
//   - an invalid row gets a zero normal when it is staged, so `|d.n| >= eps`
//     rejects it and the loop has no `valid` test;
//   - each warp tests only the rows of the union of its rays' prim ranges
//     (an emissive-target ray tests its light's two prims, not the table),
//     and without the two range compares when every ray of the warp covers
//     them;
//   - the table is staged through shared memory in tiles of 256 rows (16
//     KB), each thread copying one row with cp.async; above one tile two
//     buffers alternate, the next tile's copy in flight while the current
//     one is tested, and each thread waits for its copy just before the one
//     barrier a tile. All threads read the same row at once, a broadcast.
// Measured and not kept (PERF.md): 48 registers for 40 resident warps;
// groups aligned to 8 rows with compile-time ranks (fewer instructions in
// the loop, 15% slower at 1080p: the compiler then took the instance load
// and the update into the common path); two threads a ray, each taking
// every other group of 8 rows, their bests merged by the key (9% slower at
// 1080p and at 65,536 rays, 1.2 us faster only at 16,384 rays, 7% faster
// on a 5,120-row table that no path sends here). Big scenes do not come
// here: above 2048 triangles trace/api.py sends rays to the cluster walk
// of tile_walk.cu.

#include <climits>

#include "pair_test.cuh"

namespace {

using hikari::dot3;
using hikari::kEps;
using hikari::kF32Max;
using hikari::kRowFloat4;
using hikari::kSublanes;
using hikari::Ray;

constexpr int kThreads = 256;
constexpr int kTileRows = 256;  // rows per shared-memory tile, one per thread to copy
constexpr int kRowFloats = 16;
constexpr int kInstFloat = 13;  // the row's instance id (int32 bits)
// The rank that "bruteforce" gives every pair: equal t then never replaces,
// so the lowest prim wins.
constexpr int kRankBruteforce = 15;

// The running best of a ray: (t, rank, prim) is the key, prim -1 is none.
struct Best {
  float t;
  int prim, rank;
};

// rank(prim mod 8): the 3-bit reversal of the sublane.
__device__ __forceinline__ int sublane_rank(int prim) {
  return static_cast<int>(__brev(static_cast<unsigned>(prim)) >> 29);
}

// Packed row (trace/closest_hit.py pack_triangles):
//   [0] nx ny nz eux  [1] euy euz evx evy  [2] evz cn cu cv
//   [3] valid, inst (int32 bits), pad, pad
// Row k of the tile (prim base + k) against the ray. kFullRange: the ray's
// range [klo, khi) covers the row.
template <bool kFullRange>
__device__ __forceinline__ void test_pair(const float4* __restrict__ rows, int k, int base,
                                          const Ray& ray, int tie_or, Best& best) {
  const float4 a = rows[kRowFloat4 * k];
  const float4 b = rows[kRowFloat4 * k + 1];
  const float4 c = rows[kRowFloat4 * k + 2];
  const int inst =
      __float_as_int(reinterpret_cast<const float*>(rows)[kRowFloats * k + kInstFloat]);
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
  const bool ok = (adn >= kEps) && (t > kEps) && (u >= 0.f) && (v >= 0.f) &&
                  (__fadd_rn(u, v) <= 1.f) && (t <= best.t) && (inst != ray.excl) &&
                  (kFullRange || ((k >= ray.klo) && (k < ray.khi)));
  if (ok) {
    // t == best.t: the lesser rank wins; the first prim of a rank stays (a
    // hit's rank is >= 0, so a tie with "no hit yet", rank -1, never wins).
    const int prim = base + k;
    const int rank = sublane_rank(prim) | tie_or;
    if (t < best.t || rank < best.rank) best = {t, prim, rank};
  }
}

// The rows [k_begin, k_end) of a tile in increasing order, 8 a turn.
template <bool kFullRange>
__device__ __forceinline__ void test_rows(const float4* __restrict__ rows, int k_begin,
                                          int k_end, int base, const Ray& ray, int tie_or,
                                          Best& best) {
  int k0 = k_begin;
#pragma unroll 1
  for (; k0 + kSublanes <= k_end; k0 += kSublanes) {
#pragma unroll
    for (int s = 0; s < kSublanes; ++s)
      test_pair<kFullRange>(rows, k0 + s, base, ray, tie_or, best);
  }
  // The last, partial group.
#pragma unroll 1
  for (int k = k0; k < k_end; ++k) test_pair<kFullRange>(rows, k, base, ray, tie_or, best);
}

// Thread i starts the copy of row i of the tile (n rows from prim base).
__device__ __forceinline__ void stage_tile(float4* rows, const float4* __restrict__ tris, int base,
                                           int n) {
  const int i = threadIdx.x;
  if (i < n) {
    const float4* src = tris + static_cast<size_t>(base + i) * kRowFloat4;
#pragma unroll
    for (int c = 0; c < kRowFloat4; ++c) hikari::copy16(rows + kRowFloat4 * i + c, src + c);
  }
}

// Thread i waits for its row's copy and zeroes the normal of an invalid
// row (the pair test then rejects it on |d.n| < eps); a barrier must follow.
__device__ __forceinline__ void finish_tile(float4* rows, int n) {
  hikari::copy_wait();
  const int i = threadIdx.x;
  if (i < n && !(rows[kRowFloat4 * i + 3].x > 0.5f)) {
    float4& a = rows[kRowFloat4 * i];
    a.x = a.y = a.z = 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
    closest_hit_kernel(const float* __restrict__ o, const float* __restrict__ d,
                       const float* __restrict__ maxd, const int* __restrict__ excl,
                       const int* __restrict__ lo, const int* __restrict__ hi,
                       const float4* __restrict__ tris, int num_tris, int num_rays, int tie_or,
                       float* __restrict__ t_out, int* __restrict__ prim_out,
                       float* __restrict__ u_out, float* __restrict__ v_out) {
  extern __shared__ float4 smem[];  // one tile, or two alternating
  const int r = blockIdx.x * kThreads + threadIdx.x;
  const bool live = r < num_rays;
  Ray ray{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, -1, 0, 0};
  float md = 0.f;
  int rlo = 0, rhi = 0;
  if (live) {
    ray.ox = o[3 * r];
    ray.oy = o[3 * r + 1];
    ray.oz = o[3 * r + 2];
    ray.dx = d[3 * r];
    ray.dy = d[3 * r + 1];
    ray.dz = d[3 * r + 2];
    ray.excl = excl[r];
    md = maxd[r];
    rlo = lo[r];
    rhi = hi[r];
  }
  const bool dead = !live || rlo >= rhi || !(md > kEps);
  Best best{dead ? 0.f : fminf(md, kF32Max), -1, -1};
  // The rows some ray of the warp may take.
  const int wlo = __reduce_min_sync(0xffffffffu, dead ? INT_MAX : max(rlo, 0));
  const int whi = __reduce_max_sync(0xffffffffu, dead ? 0 : min(rhi, num_tris));

  const int num_tiles = (num_tris + kTileRows - 1) / kTileRows;
  const int buf_rows = min(num_tris, kTileRows);
  if (num_tiles > 0) stage_tile(smem, tris, 0, buf_rows);
  for (int tile = 0; tile < num_tiles; ++tile) {
    const int base = tile * kTileRows;
    const int n = min(kTileRows, num_tris - base);
    float4* rows = smem + (tile & 1) * buf_rows * kRowFloat4;
    finish_tile(rows, n);
    __syncthreads();  // the tile is in; every thread is done with the other buffer
    if (tile + 1 < num_tiles)
      stage_tile(smem + ((tile + 1) & 1) * buf_rows * kRowFloat4, tris, base + kTileRows,
                 min(kTileRows, num_tris - base - kTileRows));
    const int kb = max(wlo - base, 0);
    const int ke = min(whi - base, n);
    if (kb < ke) {
      hikari::set_range(ray, rlo, rhi, base);
      if (__all_sync(0xffffffffu, dead || (rlo <= base + kb && rhi >= base + ke)))
        test_rows<true>(rows, kb, ke, base, ray, tie_or, best);
      else
        test_rows<false>(rows, kb, ke, base, ray, tie_or, best);
    }
  }
  if (!live) return;
  float best_u = 0.f, best_v = 0.f;
  if (best.prim >= 0) {
    hikari::hit_uv(ray, best.t, tris + static_cast<size_t>(best.prim) * kRowFloat4, best_u,
                   best_v);
  }
  // torch.clamp(maxd, max=F32_MAX) on a miss: NaN stays NaN.
  t_out[r] = best.prim >= 0 ? best.t : (isnan(md) ? md : fminf(md, kF32Max));
  prim_out[r] = best.prim;
  u_out[r] = best_u;
  v_out[r] = best_v;
}

// One tile of the table, or two alternating above one tile.
size_t shared_bytes(int num_tris) {
  const int rows = num_tris > kTileRows ? 2 * kTileRows : num_tris;
  return static_cast<size_t>(rows) * kRowFloats * sizeof(float);
}

}  // namespace

extern "C" int hikari_closest_hit(const float* o, const float* d, const float* maxd,
                                  const int* excl, const int* lo, const int* hi,
                                  const float* tris, int num_tris, int num_rays, int lowest_prim,
                                  float* t_out, int* prim_out, float* u_out, float* v_out,
                                  void* stream) {
  if (num_rays <= 0) return static_cast<int>(cudaSuccess);
  const size_t smem = shared_bytes(num_tris);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* rows = reinterpret_cast<const float4*>(tris);
  const int tie_or = lowest_prim ? kRankBruteforce : 0;
  closest_hit_kernel<<<(num_rays + kThreads - 1) / kThreads, kThreads, smem, s>>>(
      o, d, maxd, excl, lo, hi, rows, num_tris, num_rays, tie_or, t_out, prim_out, u_out, v_out);
  return static_cast<int>(cudaGetLastError());
}

// Resident warps per SM of the launch that `hikari_closest_hit` makes for
// this many triangles (the occupancy query), or -1.
extern "C" int hikari_closest_hit_warps_per_sm(int num_tris) {
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, closest_hit_kernel, kThreads, shared_bytes(num_tris));
  return err == cudaSuccess ? per_sm * kThreads / 32 : -1;
}

extern "C" const char* hikari_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
