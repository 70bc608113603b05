// Tile walk of the large-scene tracer, for Hopper (sm_90a): each 512-ray
// tile walks its own list of triangle clusters near to far and retires
// early. Built by hikari_tpu_torch/trace/tile_walk.py with nvcc into a
// shared library with a plain C interface, loaded with ctypes.
//
// Replaces: hikari_tpu/trace/pallas_tiled.py `_make_kernel` -> `_kernel`
// (K2). On the TPU one grid step walks one tile in a `while_loop`, the
// cluster rows double-buffered HBM->VMEM by async DMA (the next cluster's
// copy starts, unconditionally, before the current one is tested), 8
// triangles on sublanes against the tile's rays on lanes.
//
// Inputs (the same contract as the plain twin `tile_walk_reference` in
// trace/tile_walk.py), R = T * 512 rays sorted into tiles by the caller:
// per ray o, d (R,3), maxd, early, maxent (R,) f32 and excl, lo, hi (R,)
// i32; per tile the cluster ids `order` (T,L) i32 in ascending phase-1
// entry distance and those distances `entry` (T,L) f32; the packed rows
// (L*cluster, 16) of trace/closest_hit.py pack_triangles in cluster order,
// and the cluster AABBs cmin, cmax (L,3). Block b walks tile b.
//
// Walk of one tile (pallas_tiled.py:224-302). It starts unless entry[0] is
// F32_MAX. At step j, for cluster c = order[j]:
//   1. with the skip on, c is tested only if some ray enters c's AABB
//      before its CURRENT best (the least of its eight sublane bests; slab
//      test with the signed-epsilon inverse direction);
//   2. dense-test the cluster's triangles against every ray of the tile:
//      K1's pair test with t < best, t < maxd, inst != excl and
//      lo <= prim < hi;
//   3. retire the tile when j+1 == L, or entry[j+1] is F32_MAX, or no ray
//      is still open: a ray is open when it is not done early (some
//      sublane holds a hit nearer than early), its least best >
//      entry[j+1] and maxent >= entry[j+1].
// Outputs per ray t, prim, u, v (a miss: t = min(maxd, F32_MAX), prim -1,
// u = v = 0) and per tile the number of clusters tested.
//
// Tie rule, the JAX kernel's (pallas_tiled.py:161-216, :309-326): each ray
// keeps eight running bests over the whole walk, one per (row mod 8)
// sublane of a cluster (clusters are multiples of 8 rows, so the sublane is
// also prim mod 8), each replaced only on a strict `t < best`. At the end
// the eight are halved 8 -> 4 -> 2 -> 1, taking the upper half only when
// it is strictly nearer: among equal t the sublanes win in the order
// 0, 4, 2, 6, 1, 5, 3, 7, whichever clusters the triangles lie in.
// Only t and prim are kept per sublane; the winner's u, v are recomputed
// from its row at the end (the same operations on the same values).
//
// What bounds it on this card: issue slots per ray/triangle pair under
// -fmad=false (pair_test.cuh), times the tested clusters x 512 x cluster
// pairs, spread over 132 SMs. The longest tile tests ~2.3x the mean of
// clusters (city primary rays), so it must get a whole SM. The design:
//   - one block of 1024 threads per tile, one block per SM, in kParts = 2
//     parts of 512 threads. Thread t of each part holds ray t of the tile,
//     and the parts split every cluster's rows: part p tests the row groups
//     of 8 whose index is p (mod kParts). So a tile's walk runs on 32 warps
//     with one ray a thread (2 rays a thread in one part of 256 threads, or
//     in 4 parts, measured slower on the H100: PERF.md);
//   - each part keeps its own eight sublane bests per ray. The sublane rule
//     picks the first minimum in walk order, so each best carries its key,
//     step x cluster + first row of its group, and the parts merge at the
//     end: the nearer t, and among equal t the smaller key. The votes take
//     the parts' merged least best and done-early flag every step;
//   - the cluster rows are double-buffered: while cluster order[j] is
//     tested, every thread's cp.async brings its share of order[j+1] into
//     the other buffer, unconditionally (a cluster that the skip then drops
//     costs only L2 bandwidth; the city's 35 MB table sits in the 50 MB
//     L2). After a dropped cluster the next tested one is copied and waited
//     for before its test;
//   - two barriers per step: one after which part 0 reads the other parts'
//     least bests and done-early flags, one after which every thread reads
//     the vote (the retirement vote for step j and the skip vote for step
//     j+1 together, a warp reduction and one shared atomicOr per warp into
//     a slot of three, rotated so that no reset races a write). Each thread
//     waits for its copies just before the second.
// The blocks take the tiles in tile order: a longest-first order measured
// no faster on the city's primary rays (PERF.md).

#include "pair_test.cuh"

namespace {

using hikari::kF32Max;
using hikari::kRowFloat4;
using hikari::kSublanes;
using hikari::Ray;

constexpr int kTileRays = 512;
constexpr int kParts = 2;                       // parts of the block that split the rows
constexpr int kThreads = kParts * kTileRays;    // threads per block (one tile)

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

// Where a ray's sublane bests start: torch.clamp(maxd, max=F32_MAX), NaN
// stays NaN. A best only falls by a hit (strict `t < best`), so a sublane
// holds a hit exactly when its best is below this.
__device__ __forceinline__ float init_best(float md) {
  return isnan(md) ? md : fminf(md, kF32Max);
}

// Shared memory past the rows' two buffers; index = ray of the tile.
struct Shared {
  // Per-ray values read once a step, not once a pair.
  float maxd[kTileRays], early[kTileRays], maxent[kTileRays];
  float ix[kTileRays], iy[kTileRays], iz[kTileRays];
  int lo[kTileRays], hi[kTileRays];
  int key[kParts][kSublanes][kTileRays];  // per part: each sublane best's key, -1 if none
  // Parts 1..: the least best and the done-early flag per ray, every step,
  // and the bests, for the merge at the end.
  float part_least[kParts - 1][kTileRays];
  int part_early[kParts - 1][kTileRays];
  float part_t[kParts - 1][kSublanes][kTileRays];
  int vote[4];
};

// Whether bests bt hold a hit nearer than `early` in some sublane.
__device__ __forceinline__ bool done_early(const float (&bt)[kSublanes], float init_t,
                                           float early) {
  bool done = false;
#pragma unroll
  for (int s = 0; s < kSublanes; ++s) done |= (bt[s] < init_t) && (bt[s] < early);
  return done;
}

// Whether ray q (least best `best`) enters the AABB of cluster `cid` before
// its best and its max distance (the skip test).
__device__ __forceinline__ bool enters(const Shared& sh, int q, const Ray& r, float best,
                                       const float* cmin, const float* cmax, int cid) {
  const float* bmin = cmin + 3 * cid;
  const float* bmax = cmax + 3 * cid;
  const float ax = __fmul_rn(__fsub_rn(bmin[0], r.ox), sh.ix[q]);
  const float bx = __fmul_rn(__fsub_rn(bmax[0], r.ox), sh.ix[q]);
  const float ay = __fmul_rn(__fsub_rn(bmin[1], r.oy), sh.iy[q]);
  const float by = __fmul_rn(__fsub_rn(bmax[1], r.oy), sh.iy[q]);
  const float az = __fmul_rn(__fsub_rn(bmin[2], r.oz), sh.iz[q]);
  const float bz = __fmul_rn(__fsub_rn(bmax[2], r.oz), sh.iz[q]);
  const float tlo = nan_max(nan_max(nan_min(ax, bx), nan_min(ay, by)), nan_min(az, bz));
  const float thi = nan_min(nan_min(nan_max(ax, bx), nan_max(ay, by)), nan_max(az, bz));
  const float box_entry = nan_max(tlo, 0.f);
  return (thi >= box_entry) && (box_entry < best) && (box_entry < sh.maxd[q]);
}

__global__ void __launch_bounds__(kThreads, 1)
    tile_walk_kernel(const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ maxd, const float* __restrict__ early,
                     const int* __restrict__ excl, const int* __restrict__ lo,
                     const int* __restrict__ hi, const float* __restrict__ maxent,
                     const int* __restrict__ order, const float* __restrict__ entry,
                     const float4* __restrict__ tris,
                     const float* __restrict__ cmin, const float* __restrict__ cmax,
                     int num_clusters, int cluster, int use_skip, float* __restrict__ t_out,
                     int* __restrict__ prim_out, float* __restrict__ u_out,
                     float* __restrict__ v_out, int* __restrict__ tested_out) {
  extern __shared__ float4 smem[];
  const int n16 = cluster * kRowFloat4;  // 16-byte chunks of a cluster's rows
  float4* rows = smem;                   // 2 buffers of n16
  Shared& sh = *reinterpret_cast<Shared*>(smem + 2 * n16);

  const int part = threadIdx.x / kTileRays;
  const int q = threadIdx.x % kTileRays;  // the thread's ray within the tile
  const int tile = blockIdx.x;
  const int L = num_clusters;
  const int* ord = order + static_cast<size_t>(tile) * L;
  const float* ent = entry + static_cast<size_t>(tile) * L;
  int* key = &sh.key[part][0][q];

  const int r = tile * kTileRays + q;
  Ray ray = {o[3 * r], o[3 * r + 1], o[3 * r + 2], d[3 * r], d[3 * r + 1], d[3 * r + 2],
             excl[r], 0, 0};
  if (part == 0) {
    sh.maxd[q] = maxd[r];
    sh.early[q] = early[r];
    sh.maxent[q] = maxent[r];
    sh.ix[q] = safe_inv(ray.dx);
    sh.iy[q] = safe_inv(ray.dy);
    sh.iz[q] = safe_inv(ray.dz);
    sh.lo[q] = lo[r];
    sh.hi[q] = hi[r];
  }
  // A best starting at maxd makes `t < best` imply `t < maxd`.
  float bt[kSublanes];
  const float init_t = init_best(maxd[r]);
#pragma unroll
  for (int s = 0; s < kSublanes; ++s) {
    bt[s] = init_t;
    key[s * kTileRays] = -1;
  }
  if (threadIdx.x == 0) sh.vote[0] = sh.vote[1] = sh.vote[2] = 0;

  int tested = 0;
  bool walk = ent[0] < kF32Max;  // the same value in every thread
  // The step whose cluster's rows are in rows buffer `cur` (copied, waited
  // for and past a barrier), -1 if none: the same in every thread.
  int have = -1, cur = 0;
  bool test = true;
  if (walk) {
    hikari::copy_async(rows, tris + static_cast<size_t>(ord[0]) * n16, n16);
    have = 0;
    const bool in =
        !use_skip || (part == 0 && enters(sh, q, ray, least(bt), cmin, cmax, ord[0]));
    hikari::copy_wait();
    test = __syncthreads_or(in) != 0;
  }

  for (int j = 0; walk; ++j) {
    const int next = min(j + 1, L - 1);
    const float e_next = ent[next];
    const bool more = (j + 1 < L) && (e_next < kF32Max);
    bool prefetch = false;
    if (test) {
      if (have != j) {  // the last copy was of a cluster the skip dropped
        hikari::copy_async(rows + static_cast<size_t>(cur) * n16,
                           tris + static_cast<size_t>(ord[j]) * n16, n16);
        hikari::copy_wait();
        __syncthreads();
        have = j;
      }
      // Every thread passed the last barrier, so nobody still reads the
      // other buffer and no copy into it is in flight.
      prefetch = more;
      if (prefetch)
        hikari::copy_async(rows + static_cast<size_t>(cur ^ 1) * n16,
                           tris + static_cast<size_t>(ord[j + 1]) * n16, n16);
      hikari::set_range(ray, sh.lo[q], sh.hi[q], ord[j] * cluster);
      hikari::test_cluster(rows + static_cast<size_t>(cur) * n16, part * kSublanes, cluster,
                           kParts * kSublanes, j * cluster, ray, bt, key, kTileRays);
      ++tested;
    }
    if (part > 0) {
      sh.part_least[part - 1][q] = least(bt);
      sh.part_early[part - 1][q] = done_early(bt, init_t, sh.early[q]);
    }
    __syncthreads();
    // One vote, from part 0 on every part's bests: bit 0, some ray is still
    // open after step j (retirement); bit 1, some ray enters cluster
    // order[j+1] (its skip test).
    if (part == 0) {
      float best = least(bt);
      bool done = done_early(bt, init_t, sh.early[q]);
#pragma unroll
      for (int p = 0; p < kParts - 1; ++p) {
        best = nan_min(best, sh.part_least[p][q]);
        done = done || sh.part_early[p][q];
      }
      unsigned bits = 0;
      if (!done && (best > e_next) && (sh.maxent[q] >= e_next)) bits |= 1u;
      if (use_skip && more && enters(sh, q, ray, best, cmin, cmax, ord[next])) bits |= 2u;
      bits = __reduce_or_sync(0xffffffffu, bits);
      if ((threadIdx.x & 31) == 0 && bits) atomicOr(&sh.vote[j % 3], static_cast<int>(bits));
    }
    if (prefetch) hikari::copy_wait();
    __syncthreads();
    const int all = sh.vote[j % 3];
    // Slot (j+2) % 3 was read after the previous step's second barrier and
    // is next written before the second barrier of step j+2.
    if (threadIdx.x == 0) sh.vote[(j + 2) % 3] = 0;
    if (prefetch) {
      cur ^= 1;
      have = j + 1;
    }
    walk = more && (all & 1);
    test = !use_skip || (all & 2);
  }

  // Merge the parts: the nearer best, and among equal t the one found
  // first in walk order (the smaller key).
  if (part > 0) {
#pragma unroll
    for (int s = 0; s < kSublanes; ++s) sh.part_t[part - 1][s][q] = bt[s];
  }
  __syncthreads();
  if (part > 0) return;
  int bp[kSublanes];
#pragma unroll
  for (int s = 0; s < kSublanes; ++s) {
    int k = sh.key[0][s][q];
#pragma unroll
    for (int p = 1; p < kParts; ++p) {
      const float tp = sh.part_t[p - 1][s][q];
      const int kp = sh.key[p][s][q];
      if (tp < bt[s] || (tp == bt[s] && kp < k)) {
        bt[s] = tp;
        k = kp;
      }
    }
    // key = step x cluster + first row of the group; prim = the step's
    // cluster x cluster + that row + s.
    bp[s] = k >= 0 ? ord[k / cluster] * cluster + k % cluster + s : -1;
  }
  hikari::halve(bt, bp);
  float u = 0.f, v = 0.f;
  if (bp[0] >= 0)
    hikari::hit_uv(ray, bt[0], tris + static_cast<size_t>(bp[0]) * kRowFloat4, u, v);
  t_out[r] = bt[0];
  prim_out[r] = bp[0];
  u_out[r] = u;
  v_out[r] = v;
  if (threadIdx.x == 0) tested_out[tile] = tested;
}

}  // namespace

extern "C" int hikari_tile_walk(const float* o, const float* d, const float* maxd,
                                const float* early, const int* excl, const int* lo,
                                const int* hi, const float* maxent, const int* order,
                                const float* entry, const float* tris,
                                const float* cmin, const float* cmax, int num_tiles,
                                int num_clusters, int cluster, int use_skip, float* t_out,
                                int* prim_out, float* u_out, float* v_out, int* tested_out,
                                void* stream) {
  if (num_tiles <= 0) return static_cast<int>(cudaSuccess);
  const int smem = 2 * cluster * kRowFloat4 * static_cast<int>(sizeof(float4)) +
                   static_cast<int>(sizeof(Shared));
  const cudaError_t err = cudaFuncSetAttribute(
      tile_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  tile_walk_kernel<<<num_tiles, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      o, d, maxd, early, excl, lo, hi, maxent, order, entry,
      reinterpret_cast<const float4*>(tris), cmin, cmax, num_clusters, cluster, use_skip, t_out,
      prim_out, u_out, v_out, tested_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* hikari_tile_walk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
