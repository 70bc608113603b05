// Per-item closest hit of the cluster-major scatter tracer, for Hopper
// (sm_90a): every 128-item block tests its items against the 128 triangles
// of its one cluster. Built by hikari_tpu_torch/trace/scatter.py with nvcc
// into a shared library with a plain C interface, loaded with ctypes.
//
// Replaces: hikari_tpu/trace/scatter.py `_make_kernel` -> `_kernel` (K3).
// On the TPU the grid walks the item blocks in order and keeps the last
// cluster's rows resident in VMEM (`resid`), reloading them only when the
// cluster changes; 8 triangles on sublanes meet 128 items on lanes.
//
// Inputs (the same contract as the plain twin `scatter_items_reference` in
// trace/scatter.py): meta (NB,2) i32 — per block its cluster id and valid
// item count —; the item fields (11, NB*128) f32, rows o(3) d(3) maxd, then
// excl, lo, hi as int32 bits, then valid (0/1); the packed rows
// (L*128, 16) of trace/closest_hit.py pack_triangles in cluster order.
// Besides, `ranges` (G,4) i32 (trace/scatter.py run_ranges): the item
// blocks of persistent block g are [w0, w1) then [t0, t1).
// Outputs per item t, prim, u, v. A block with count 0 writes misses:
// t = F32_MAX, prim = -1, u = v = 0; so does an item that hits nothing. A
// block with a count and a cluster id outside [0, L) reads no rows, writes
// misses and adds 1 to `errors` (the wrapper raises nothing: a trap would
// poison the CUDA context).
//
// The pair test is K1's (pallas_kernel.py / scatter.py:142-166): t < best,
// t < maxd, inst != excl, lo <= prim < hi, item and triangle valid.
//
// Tie rule: the JAX kernel's, as in K1 and K2. Triangle j goes to sublane
// j mod 8; each sublane keeps its first minimum (strict `<`, so its lowest
// prim); the eight bests are halved 8 -> 4 -> 2 -> 1, taking the upper
// half only when it is strictly nearer (scatter.py:182-194). Among equal t
// the sublanes win in the order 0, 4, 2, 6, 1, 5, 3, 7. Only t and prim
// are kept per sublane; the winner's u, v are recomputed from its row at
// the end (the same operations on the same values).
//
// What bounds it on this card: issue slots per item/triangle pair under
// -fmad=false (pair_test.cuh), used blocks x 128 x 128 pairs; the bytes
// (the 11 fields and 4 results of every item slot, the rows) are ~30x
// fewer than the pairs' work. The design:
//   - persistent blocks of 128 threads, one item per thread; the grid is
//     as many blocks as fit on the card at once. (Two items per thread read
//     each row once for both, but their 102-119 registers left 7 blocks of
//     2 warps per SM, where one item's 71 leave 7 blocks of 4, and ran
//     slower on the H100: PERF.md);
//   - block g walks a contiguous range of the used item blocks and one of
//     the unused ones (`ranges`, balanced by used blocks). Blocks are
//     cluster-major, so a cluster's rows stay resident in shared memory
//     across its run, as the TPU kernel's `resid` does: they are loaded
//     only when the cluster changes;
//   - while item block i is tested, the threads' cp.async bring block
//     i+1's fields, and its cluster's rows when that changes, into the
//     other buffers; each thread waits for its copies just before the one
//     barrier of the step. A used block that follows an unused one in the
//     range is copied and waited for first;
//   - an unused block writes its misses with one 16-byte store per thread
//     per output and reads nothing but its meta.

#include "pair_test.cuh"

namespace {

using hikari::kF32Max;
using hikari::kRowFloat4;
using hikari::kSublanes;
using hikari::Ray;

constexpr int kBlockItems = 128;
constexpr int kCluster = 128;
constexpr int kThreads = kBlockItems;  // threads per persistent block, one item each
constexpr int kFields = 11;
constexpr int kRows16 = kCluster * kRowFloat4;   // 16-byte chunks of a cluster's rows
constexpr int kField16 = kBlockItems / 4;        // 16-byte chunks of one field of a block

struct Stage {
  float f[kFields][kBlockItems];
};

// Item block `blk`'s fields into `st`, without waiting.
__device__ __forceinline__ void copy_fields(Stage& st, const float* fields, size_t cap,
                                            int blk) {
  const float* src = fields + static_cast<size_t>(blk) * kBlockItems;
  for (int c = threadIdx.x; c < kFields * kField16; c += kThreads) {
    const int k = c / kField16, q = c % kField16;
    hikari::copy16(&st.f[k][4 * q], src + k * cap + 4 * q);
  }
}

// Item block i of a persistent block's ranges: [w0, w1) then [t0, t1).
__device__ __forceinline__ int block_at(const int4& rg, int nw, int i) {
  return i < nw ? rg.x + i : rg.z + (i - nw);
}

__global__ void __launch_bounds__(kThreads)
    scatter_items_kernel(const int* __restrict__ meta, const float* __restrict__ fields,
                         const float4* __restrict__ tris, const int4* __restrict__ ranges,
                         int num_blocks, int num_clusters, float* __restrict__ t_out,
                         int* __restrict__ prim_out, float* __restrict__ u_out,
                         float* __restrict__ v_out, int* __restrict__ errors) {
  __shared__ __align__(16) float4 rows[2][kRows16];
  __shared__ __align__(16) Stage stage[2];
  __shared__ int key[kSublanes][kBlockItems];  // each sublane best's row group, -1 if none

  const int4 rg = ranges[blockIdx.x];
  const int nw = rg.y - rg.x;
  const int n = nw + (rg.w - rg.z);
  const size_t cap = static_cast<size_t>(num_blocks) * kBlockItems;
  auto usable = [&](int cid, int count) {
    return count != 0 && cid >= 0 && cid < num_clusters;
  };

  // Copy state, the same in every thread: the item block whose fields are
  // in stage[cur] and the cluster whose rows are in rows[rb] (-1: none),
  // each copied, waited for and past a barrier.
  int staged = -1, cur = 0, res = -1, rb = 0;
  const int q = threadIdx.x;  // the thread's item within the block

  for (int i = 0; i < n; ++i) {
    const int blk = block_at(rg, nw, i);
    const int cid = meta[2 * blk], count = meta[2 * blk + 1];
    const int item0 = blk * kBlockItems;
    if (!usable(cid, count)) {
      if (count != 0 && threadIdx.x == 0) atomicAdd(errors, 1);
      // Warp w writes output w (t, prim, u, v), 16 bytes a thread.
      const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
      if (warp == 0)
        reinterpret_cast<float4*>(t_out + item0)[lane] =
            make_float4(kF32Max, kF32Max, kF32Max, kF32Max);
      else if (warp == 1)
        reinterpret_cast<int4*>(prim_out + item0)[lane] = make_int4(-1, -1, -1, -1);
      else
        reinterpret_cast<float4*>(warp == 2 ? u_out + item0 : v_out + item0)[lane] =
            make_float4(0.f, 0.f, 0.f, 0.f);
      continue;
    }
    // Past the last barrier every buffer but the staged ones is free and no
    // copy is in flight.
    if (staged != blk) {  // not prefetched: copy it now
      copy_fields(stage[cur], fields, cap, blk);
      if (cid != res) {
        rb ^= 1;
        res = cid;
        hikari::copy_async(rows[rb], tris + static_cast<size_t>(cid) * kRows16, kRows16);
      }
      hikari::copy_wait();
      __syncthreads();
      staged = blk;
    }
    int nblk = -1, ncid = -1;
    if (i + 1 < n) {
      nblk = block_at(rg, nw, i + 1);
      ncid = meta[2 * nblk];
      if (usable(ncid, meta[2 * nblk + 1])) {
        copy_fields(stage[cur ^ 1], fields, cap, nblk);
        if (ncid != res)
          hikari::copy_async(rows[rb ^ 1], tris + static_cast<size_t>(ncid) * kRows16, kRows16);
      } else {
        nblk = -1;
      }
    }

    const int base = cid * kCluster;
    const float(&f)[kFields][kBlockItems] = stage[cur].f;
    Ray ray = {f[0][q], f[1][q], f[2][q], f[3][q], f[4][q], f[5][q], __float_as_int(f[7][q]),
               0, 0};
    hikari::set_range(ray, __float_as_int(f[8][q]), __float_as_int(f[9][q]), base);
    // The bests start at maxd (already clamped to F32_MAX), or at 0 for an
    // item that is not valid: `t < best` then carries `t < maxd` and
    // `valid`, since every hit has t > eps > 0.
    const float init_t = f[10][q] > 0.5f ? f[6][q] : 0.f;
    float bt[kSublanes];
#pragma unroll
    for (int k = 0; k < kSublanes; ++k) {
      bt[k] = init_t;
      key[k][q] = -1;
    }
    hikari::test_cluster(rows[rb], 0, kCluster, kSublanes, base, ray, bt, &key[0][q],
                         kBlockItems);
    int bp[kSublanes];  // sublane k's key is its row group's first prim
#pragma unroll
    for (int k = 0; k < kSublanes; ++k) bp[k] = key[k][q] >= 0 ? key[k][q] + k : -1;
    hikari::halve(bt, bp);
    float t = kF32Max, u = 0.f, v = 0.f;
    if (bp[0] >= 0) {
      t = bt[0];
      hikari::hit_uv(ray, t, &rows[rb][kRowFloat4 * (bp[0] - base)], u, v);
    }
    t_out[item0 + q] = t;
    prim_out[item0 + q] = bp[0];
    u_out[item0 + q] = u;
    v_out[item0 + q] = v;
    if (nblk >= 0) hikari::copy_wait();
    __syncthreads();
    if (nblk >= 0) {
      cur ^= 1;
      staged = nblk;
      if (ncid != res) {
        rb ^= 1;
        res = ncid;
      }
    }
  }
}

}  // namespace

// Persistent blocks that fit on the current card at once; a launch takes
// that many, at most one per item block.
extern "C" int hikari_scatter_items_grid() {
  int device = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, scatter_items_kernel, kThreads,
                                                    0) != cudaSuccess)
    return -1;
  return sms * per_sm;
}

extern "C" int hikari_scatter_items(const int* meta, const float* fields, const float* tris,
                                    const int* ranges, int grid, int num_blocks,
                                    int num_clusters, float* t_out, int* prim_out, float* u_out,
                                    float* v_out, int* errors, void* stream) {
  if (grid <= 0 || num_blocks <= 0) return static_cast<int>(cudaSuccess);
  scatter_items_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      meta, fields, reinterpret_cast<const float4*>(tris), reinterpret_cast<const int4*>(ranges),
      num_blocks, num_clusters, t_out, prim_out, u_out, v_out, errors);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* hikari_scatter_items_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
