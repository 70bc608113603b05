// Window-table pack for Hopper (sm_90a): C planes of (H, W) f32 and D
// column taps become one (H*W, C*D) row table,
//   out[y*W + x, c*D + j] = planes[c, y, min(x + dxs[j], W - 1)],
// the table a post-chain tap gathers one row of per pixel. Built by
// hikari_tpu_torch/tools/prims.py with nvcc into a shared library with a
// plain C interface, loaded with ctypes.
//
// Replaces: tools/bench_pallas_prims.py `pack_kernel_v2` / `pallas_pack_v2`
// (T1, the fused window-pack candidate, pallas_call at :153). On the TPU a
// grid step DMAs a (TB + 2*MD)-row slab of every edge-padded plane into VMEM
// under semaphores and transposes one (K, W) row matrix into a (W, K) table
// block. Those slabs and semaphores exist for VMEM and are not carried over.
//
// What bounds it: bytes. At 8 planes of 1080 x 1920 and 16 taps it reads
// 66.4 MB and writes 1,061.7 MB, so at 3.35 TB/s it cannot take less than
// ~0.337 ms; there is no arithmetic. The design keeps the writes at the
// memory's pace:
//   - one block takes one image row and a run of kRun columns, and stages
//     the C planes' row segment plus the max(dxs) halo to its right in
//     shared memory, clamping at the right edge itself (no padded copy of
//     the planes is made); the planes are read about once;
//   - the block writes its (kRun, C*D) table block row by row, one warp per
//     row, each lane a 16-byte store to neighbouring addresses: with C*D =
//     128 one 512-byte table row per 32 threads, fully coalesced.
// The taps come from shared memory, so the transpose costs no device-memory
// traffic.

#include <cuda_runtime.h>

namespace {

constexpr int kRun = 128;      // image columns per block
constexpr int kThreads = 256;  // 8 warps; warp w writes table rows w, w + 8, ...
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
    window_pack_kernel(const float* __restrict__ planes, const int* __restrict__ dxs,
                       int C, int H, int W, int D, int halo, float4* __restrict__ out) {
  extern __shared__ float smem[];  // C * (kRun + halo) floats, then D ints
  const int span = kRun + halo;
  int* taps = reinterpret_cast<int*>(smem + C * span);
  const int y = blockIdx.y;
  const int x0 = blockIdx.x * kRun;

  for (int j = threadIdx.x; j < D; j += kThreads) taps[j] = dxs[j];
  const size_t plane = static_cast<size_t>(H) * W;
  const float* row = planes + static_cast<size_t>(y) * W;
  for (int i = threadIdx.x; i < C * span; i += kThreads) {
    const int c = i / span;
    const int gx = min(x0 + (i - c * span), W - 1);  // clamp at the right edge
    smem[i] = row[c * plane + gx];
  }
  __syncthreads();

  const int K4 = (C * D) / 4;  // float4 per table row
  const int lane = threadIdx.x % 32;
  const int n = min(kRun, W - x0);
  for (int xl = threadIdx.x / 32; xl < n; xl += kWarps) {
    float4* dst = out + (static_cast<size_t>(y) * W + x0 + xl) * K4;
    for (int q = lane; q < K4; q += 32) {
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = 4 * q + i;
        const int c = k / D;
        v[i] = smem[c * span + xl + taps[k - c * D]];
      }
      dst[q] = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

}  // namespace

// planes (C, H, W) f32 contiguous, dxs (D,) i32 in [0, halo], out (H*W, C*D)
// f32 with C*D a multiple of 4 and 16-byte aligned. Returns a cudaError_t.
extern "C" int hikari_window_pack(const float* planes, const int* dxs, int C, int H, int W,
                                  int D, int halo, float* out, void* stream) {
  if (C <= 0 || H <= 0 || W <= 0 || D <= 0) return static_cast<int>(cudaSuccess);
  const int smem = (C * (kRun + halo)) * static_cast<int>(sizeof(float)) +
                   D * static_cast<int>(sizeof(int));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        window_pack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((W + kRun - 1) / kRun, H);
  window_pack_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      planes, dxs, C, H, W, D, halo, reinterpret_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* hikari_window_pack_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
