// Repeated gather along one axis for Hopper (sm_90a):
//   out = sum over r < reps of take_along_axis(x + r, idx, axis, mode),
// summed from 0 in r order, x (M, N) f32, idx and out (OM, ON) with the
// other axis equal to x's. Built by hikari_tpu_torch/tools/prims.py with nvcc
// into a shared library with a plain C interface, loaded with ctypes.
//
// Replaces: tools/bench_pallas_prims.py `make_g` (T2, pallas_call at :193:
// one take_along_axis in one VMEM block) and `make_vreg_g` (T3, :227: the
// same gather of x + r repeated reps_inner times and summed). On the TPU they
// probe `tpu.dynamic_gather`, which needs the gather axis to fit one vreg;
// here any shape is one thread per output element.
//
// Index rule, jnp.take_along_axis's: a negative index gains the axis length
// once; mode 1 ("clip") then clamps into [0, n - 1]; mode 0 (None, "fill")
// gives NaN for an index still outside [0, n - 1].
//
// What bounds it: at the probes' shapes ((512, 512); (512, 128) and
// (8, 1024) with up to 128 repeats) the bytes (x, idx and out, each once:
// 0.8-3 MB, ~0.2-0.9 us at 3.35 TB/s) and the adds (2 per repeat) take less
// than a kernel launch does, so the floor is the launch: an empty kernel of
// the same grid (hikari_take_along_empty) measures it. Above it lie each
// output's dependent chain (the idx load, the gather, `reps` dependent
// adds, the store) and, gathering across rows, a 32-byte sector read for
// every 4-byte value. The design is the plainest one: one output per
// thread, so every SM has warps; the gathered value is loaded once and the
// repeats add in registers, in the twin's order (acc = acc + (x + r),
// round-to-nearest __fadd_rn, no FMA), so the result is bitwise the twin's.
// Measured slower on the H100 and not kept (PERF.md): 4 outputs a thread
// with 16-byte idx loads and stores and 4 independent add chains (fewer
// blocks: SMs idle at these sizes, and 4 chains through one warp's issue);
// one output a thread in a one-wave grid-stride grid; the same kernel
// templated on the axis and the index mode; and x's columns staged in
// shared memory for an axis-0 gather (one sector a row, 64 blocks).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    take_along_kernel(const float* __restrict__ x, const int* __restrict__ idx, int M, int N,
                      int OM, int ON, int axis, int reps, int clip, float* __restrict__ out) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= OM * ON) return;
  const int i = e / ON;
  const int j = e - i * ON;
  const int n = axis == 0 ? M : N;
  int g = idx[e];
  if (g < 0) g += n;
  bool valid = true;
  if (clip) {
    g = min(max(g, 0), n - 1);
  } else {
    valid = g >= 0 && g < n;
  }
  const float xv = valid ? x[axis == 0 ? static_cast<size_t>(g) * N + j
                                       : static_cast<size_t>(i) * N + g]
                         : __int_as_float(0x7fc00000);  // NaN, the fill value
  float acc = 0.f;
  for (int r = 0; r < reps; ++r) acc = __fadd_rn(acc, __fadd_rn(xv, static_cast<float>(r)));
  out[e] = acc;
}

__global__ void __launch_bounds__(kThreads) empty_kernel() {}

int blocks_for(int total) { return (total + kThreads - 1) / kThreads; }

}  // namespace

// x (M, N) f32, idx (OM, ON) i32, out (OM, ON) f32, all contiguous; axis 0
// or 1; clip 1 for mode "clip", 0 for None/"fill". Returns a cudaError_t.
extern "C" int hikari_take_along(const float* x, const int* idx, int M, int N, int OM, int ON,
                                 int axis, int reps, int clip, float* out, void* stream) {
  const int total = OM * ON;
  if (total <= 0) return static_cast<int>(cudaSuccess);
  take_along_kernel<<<blocks_for(total), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, idx, M, N, OM, ON, axis, reps, clip, out);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel with the grid and block of hikari_take_along for OM x ON
// outputs: its device time is the launch floor of the gathers.
extern "C" int hikari_take_along_empty(int OM, int ON, void* stream) {
  const int total = OM * ON;
  if (total <= 0) return static_cast<int>(cudaSuccess);
  empty_kernel<<<blocks_for(total), kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* hikari_take_along_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
