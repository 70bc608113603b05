// The spatial reuse's tap loop for Hopper (sm_90a): every neighbour tap of
// render/spatial.py's rolled spiral (settings.spatial_taps == "rolls") in
// one launch, one thread a pixel, the running reservoir in registers. Built
// by render/spatial.py with nvcc into a shared library with a plain C
// interface, loaded with ctypes.
//
// Replaces no Pallas kernel: the JAX package's spatial reuse is jnp
// (hikari_tpu/render/spatial.py:87). It replaces the port's ATen tap loop,
// kept as the plain twin (spatial.spatial_taps_reference): 16 calls of
// rolled_tap at ~375 launches each (a gather a reservoir field, the march's
// depth gathers, the rejections, the Jacobian, the BRDF, merge_reservoir's
// selects over 28 channels) and 6 blocking uploads of host tables each.
//
// Per tap i of a pixel (light.wgsl:1566-1642): the pixel's variant
// k = (variant + i) mod K fixes the tap's integer offset (oy, ox) and its
// march offsets, computed on the host in float32 as the twin computes them
// and passed by value (SpatialTaps, 1,932 B), so the loop takes no host
// sync; each block copies it to shared memory, where lanes that index it
// by their own variant do not serialise as in the parameter bank.
// The neighbour at the wrapped offset is rejected on the depth ratio, an
// empty reservoir, the normals, the backface and a screen-space march over
// the depth plane, else merged with the GRIS Jacobian and the target
// (the BRDF's luminance for the indirect channel, the radiance's for the
// emissive one) by merge_reservoir's arithmetic. The index of the last
// neighbour whose sample was taken comes back a pixel (-1: the reservoir
// that came in kept its sample), so the caller can rebuild the radiance
// under autograd.
//
// Bit for bit with the twin on the card: every operation is the one ATen
// runs, in the twin's order, built without multiply-add contraction
// (-fmad=false): IEEE division and sqrtf, as ATen's kernels; powf for
// torch.pow(x, 5.0); clamp's NaN rule; a last-axis sum of 3 or 4 in the
// order of ATen's reduction (sum3, sum4); Python's float constants rounded
// from double to float. A rejected tap leaves the reservoir as it was, as
// the twin's masked select does, so a neighbour is read only as far as
// its rejections need. The per-pixel factors of the BRDF that no tap
// changes (f0, the diffuse colour, NoV, the Fresnel f90, the ambient term)
// come in as planes that the twin's own functions computed.
//
// What bounds it: bytes. Each pixel reads its running reservoir (26
// channels) and its own inputs (24 channels; 9 for the emissive), writes
// 26 channels and its winner, and the gathered grid (25 channels) and
// depth plane are read once: 213,580,800 B at 960x540, 0.0638 ms at 3.35
// TB/s (render/spatial.py bound_bytes). The taps' own reads (a
// neighbour's reservoir, up to 5 march depths, 16 taps) are several times
// that, but every tap lies within 20 pixels, so they come from the caches:
// 2D blocks of 32x8 pixels keep a warp's taps at one variant on
// neighbouring addresses, every input goes through the read-only path
// (__ldg), and the reservoir's planes are read where they lie (one pointer
// a field), so no pass repacks them. A neighbour is read in the order of
// its rejections, as far as they let it pass. Measured on the H100 (PERF.md
// section 6): 0.30 ms a 16-tap call, 21% of the bound, 103 registers;
// issuing all of a tap's reads at once (108 registers) was 3% slower, and
// 3 blocks an SM (80 registers, with spills) 4% faster, 0.01 ms of a 75 ms
// frame: not kept.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTaps = 16;
constexpr int kMaxVariants = 8;
constexpr int kMaxMarch = 5;  // SPATIAL_REUSE_TAPS + 1
constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

// Python's float constants of the twin, rounded from double to float as
// ATen rounds a scalar operand.
constexpr float kDepthGuard = static_cast<float>(1e-8);
constexpr float kRatioLow = static_cast<float>(0.9);
constexpr float kRatioHigh = static_cast<float>(1.1);
constexpr float kEpsilon = static_cast<float>(1.1920929e-7);  // F32_EPSILON
constexpr float kNormalCos = static_cast<float>(0.866);
constexpr float kMarchBias = static_cast<float>(1e-5);
constexpr float kNormEps2 = static_cast<float>(1e-18 * 1e-18);  // safe_normalize
constexpr float kJacobianFloor = static_cast<float>(0.0001);
constexpr float kVisFloor = static_cast<float>(1e-7);
constexpr float kInvPi = static_cast<float>(1.0 / 3.1415926);
constexpr float kLumR = static_cast<float>(0.2126);
constexpr float kLumG = static_cast<float>(0.7152);
constexpr float kLumB = static_cast<float>(0.0722);

}  // namespace

// One pointer a field of a Reservoir grid, each a contiguous plane of n
// pixels: radiance, random, visible_position and sample_position (n, 4),
// visible_normal and sample_normal (n, 3), the rest (n,). A field the call
// does not use may be null (the grid's w_sum and w2_sum, the output's w).
struct SpatialReservoir {
  float* radiance;
  float* random;
  float* visible_position;
  float* visible_normal;
  int* visible_instance;
  float* sample_position;
  float* sample_normal;
  float* count;
  float* w;
  float* w_sum;
  float* w2_sum;
};

// The block's own pixels (lh, lw): the G-buffer depth, the temporal
// sample's visible position (xyz of 4) and normal, the variant; for the
// indirect channel the BRDF's per-pixel factors (null for the emissive).
struct SpatialPixels {
  const float* depth;
  const float* position;
  const float* normal;
  const int* variant;
  const float* view;       // (lh, lw, 3)
  const float* f0;         // (lh, lw, 3)
  const float* diffuse;    // (lh, lw, 3)
  const float* roughness;  // (lh, lw)
  const float* nov;        // (lh, lw): clamp(dot(n, v), min=1e-4)
  const float* f90;        // (lh, lw): saturate(sum(f0 * 16.5))
  const float* ambient;    // (lh, lw, 3): the ambient term of shading
};

// The spiral of one pass, by value. offset[t][k] is tap t + 1's (oy, ox)
// under variant k, march[t][k][j] its j-th march offset (ty, tx), and
// march_frac[t][j] = (j + 1) / (tap count + 1) in float32.
struct SpatialTaps {
  int taps;
  int variants;
  int emissive;
  int march_count[kMaxTaps];
  float march_frac[kMaxTaps][kMaxMarch];
  int8_t offset[kMaxTaps][kMaxVariants][2];
  int8_t march[kMaxTaps][kMaxVariants][kMaxMarch][2];
};

static_assert(sizeof(SpatialTaps) % 4 == 0, "the kernel copies the table in words");

// The image (rh, rw) whose gathered grid the taps read, and the block
// (origin y0, x0; size lh, lw) whose pixels the call computes.
struct SpatialFrame {
  int rh, rw, y0, x0, lh, lw;
};

namespace {

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ float ld(const float* p, size_t i) { return __ldg(p + i); }

__device__ __forceinline__ V3 ld3(const float* p, size_t i) {
  return {__ldg(p + 3 * i), __ldg(p + 3 * i + 1), __ldg(p + 3 * i + 2)};
}

__device__ __forceinline__ V3 ld4xyz(const float* p, size_t i) {
  return {__ldg(p + 4 * i), __ldg(p + 4 * i + 1), __ldg(p + 4 * i + 2)};
}

__device__ __forceinline__ V3 sub3(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }

// ATen's sum over a last axis of 3 (a contiguous (n, 3) on the card): two
// lanes of a warp share the row, lane 0 adds elements 0 and 2 and lane 1
// holds element 1, each starting from +0, then lane 0 adds lane 1's.
__device__ __forceinline__ float sum3(float a0, float a1, float a2) {
  return ((0.f + a0) + (0.f + a2)) + (0.f + a1);
}

// ATen's sum over a last axis of 4: four lanes, one element each from +0,
// shuffled down by 2 and then by 1.
__device__ __forceinline__ float sum4(float a0, float a1, float a2, float a3) {
  return ((0.f + a0) + (0.f + a2)) + ((0.f + a1) + (0.f + a3));
}

__device__ __forceinline__ float dot3(V3 a, V3 b) { return sum3(a.x * b.x, a.y * b.y, a.z * b.z); }

// torch.clamp(v, min=lo) and torch.clamp(v, lo, hi) on the card: NaN passes.
__device__ __forceinline__ float clamp_min(float v, float lo) { return isnan(v) ? v : fmaxf(v, lo); }

__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// utils.safe_normalize: v / sqrt(max(|v|^2, 1e-36)).
__device__ __forceinline__ V3 safe_normalize(V3 v) {
  const float n = sqrtf(clamp_min(sum3(v.x * v.x, v.y * v.y, v.z * v.z), kNormEps2));
  return {v.x / n, v.y / n, v.z / n};
}

__device__ __forceinline__ float luminance(float r, float g, float b) {
  return (r * kLumR + g * kLumG) + b * kLumB;
}

// restir.compute_jacobian(q, s) for the pixel at `pos`: the neighbour's
// visible and sample positions and sample normal.
__device__ __forceinline__ float jacobian(V3 q_visible, V3 q_sample, V3 q_normal, V3 pos) {
  const V3 d_r = sub3(pos, q_sample);
  const V3 d_q = sub3(q_visible, q_sample);
  const float cos_phi_1 = fabsf(dot3(safe_normalize(d_r), q_normal));
  const float cos_phi_2 = fabsf(dot3(safe_normalize(d_q), q_normal));
  const float term_1 = cos_phi_1 / clamp_min(cos_phi_2, kJacobianFloor);
  const float term_2 = sum3(d_q.x * d_q.x, d_q.y * d_q.y, d_q.z * d_q.z) /
                       clamp_min(sum3(d_r.x * d_r.x, d_r.y * d_r.y, d_r.z * d_r.z), kJacobianFloor);
  return clamp(term_1 * term_2, 1.f, 50.f);
}

// The pixel's BRDF factors that no tap changes.
struct Brdf {
  V3 v, f0, diffuse, ambient;
  float roughness, nov, f90;
  float nov_pow;  // pow(1 - nov, 5), fd_burley's view term
};

// luminance(brdf.shading(v, n, l, surface, radiance, ambient_color)): lit's
// Burley diffuse and GGX specular (fd_burley, d_ggx, v_smith_ggx_correlated,
// fresnel) times NoL, mixed with the ambient term by the radiance's alpha.
__device__ __forceinline__ float shade_luminance(const Brdf& b, V3 n, V3 l, const float rad[4]) {
  const V3 h = safe_normalize({l.x + b.v.x, l.y + b.v.y, l.z + b.v.z});
  const float nol = clamp(dot3(n, l), 0.f, 1.f);
  const float noh = clamp(dot3(n, h), 0.f, 1.f);
  const float loh = clamp(dot3(l, h), 0.f, 1.f);
  const float r = b.roughness;
  const float nov = b.nov;
  // fd_burley
  const float burley_f90 = r * 2.f * loh * loh + 0.5f;
  const float light_scatter = (burley_f90 - 1.f) * powf(1.f - nol, 5.f) + 1.f;
  const float view_scatter = (burley_f90 - 1.f) * b.nov_pow + 1.f;
  const float fd = light_scatter * view_scatter * kInvPi;
  // d_ggx
  const float one_minus = 1.f - noh * noh;
  const float a = noh * r;
  const float k = r / (one_minus + a * a);
  const float d = k * k * kInvPi;
  // v_smith_ggx_correlated: 0.5 / x is reciprocal(x) * 0.5 in torch
  const float a2 = r * r;
  const float lambda_v = nol * sqrtf((nov - a2 * nov) * nov + a2);
  const float lambda_l = nov * sqrtf((nol - a2 * nol) * nol + a2);
  const float vis = (1.f / clamp_min(lambda_v + lambda_l, kVisFloor)) * 0.5f;
  // fresnel, then specular's (1.0 * d * v) * f
  const float fresnel_pow = powf(1.f - loh, 5.f);
  const float dv = d * vis;
  const float alpha = rad[3];
  const float f0[3] = {b.f0.x, b.f0.y, b.f0.z};
  const float diffuse[3] = {b.diffuse.x, b.diffuse.y, b.diffuse.z};
  const float ambient[3] = {b.ambient.x, b.ambient.y, b.ambient.z};
  float c[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float f = f0[ch] + (b.f90 - f0[ch]) * fresnel_pow;
    const float spec = dv * f;
    const float lit = (spec + diffuse[ch] * fd) * rad[ch] * nol;
    c[ch] = lit * alpha + ambient[ch] * (1.f - alpha);
  }
  return luminance(c[0], c[1], c[2]);
}

// torch.remainder(v, n) for n > 0.
__device__ __forceinline__ int wrap(int v, int n) {
  const int m = v % n;
  return m < 0 ? m + n : m;
}

__global__ void __launch_bounds__(kBlockX* kBlockY)
    spatial_reuse_kernel(SpatialReservoir r_in, SpatialReservoir grid,
                         const float* __restrict__ depth_all, SpatialPixels px, SpatialTaps taps,
                         SpatialFrame f, SpatialReservoir out, int* __restrict__ winner) {
  // The table in shared memory: lanes of a warp index it by their own
  // variant, which the parameter bank would serialise.
  __shared__ SpatialTaps tab;
  {
    const int* src = reinterpret_cast<const int*>(&taps);
    int* dst = reinterpret_cast<int*>(&tab);
    for (int i = threadIdx.y * kBlockX + threadIdx.x; i < int(sizeof(SpatialTaps) / 4);
         i += kBlockX * kBlockY) {
      dst[i] = src[i];
    }
  }
  __syncthreads();
  const int lx = blockIdx.x * kBlockX + threadIdx.x;
  const int ly = blockIdx.y * kBlockY + threadIdx.y;
  if (lx >= f.lw || ly >= f.lh) return;
  const size_t p = static_cast<size_t>(ly) * f.lw + lx;
  const int x = f.x0 + lx;
  const int y = f.y0 + ly;

  const float depth = ld(px.depth, p);
  const V3 pos = ld4xyz(px.position, p);
  const V3 n = ld3(px.normal, p);
  const int variant = __ldg(px.variant + p);
  Brdf b{};
  if (!tab.emissive) {
    b.v = ld3(px.view, p);
    b.f0 = ld3(px.f0, p);
    b.diffuse = ld3(px.diffuse, p);
    b.ambient = ld3(px.ambient, p);
    b.roughness = ld(px.roughness, p);
    b.nov = ld(px.nov, p);
    b.f90 = ld(px.f90, p);
    b.nov_pow = powf(1.f - b.nov, 5.f);
  }

  // The running reservoir (lifetime and w pass through unchanged).
  float rad[4], rnd[4], vis_pos[4], smp_pos[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    rad[c] = ld(r_in.radiance, 4 * p + c);
    rnd[c] = ld(r_in.random, 4 * p + c);
    vis_pos[c] = ld(r_in.visible_position, 4 * p + c);
    smp_pos[c] = ld(r_in.sample_position, 4 * p + c);
  }
  V3 vis_n = ld3(r_in.visible_normal, p);
  V3 smp_n = ld3(r_in.sample_normal, p);
  int inst = __ldg(r_in.visible_instance + p);
  float count = ld(r_in.count, p);
  float w_sum = ld(r_in.w_sum, p);
  float w2_sum = ld(r_in.w2_sum, p);
  int win = -1;

  for (int t = 0; t < tab.taps; ++t) {
    const int k = wrap(variant + t + 1, tab.variants);
    const int sy = y + tab.offset[t][k][0];
    const int sx = x + tab.offset[t][k][1];
    if (sx < 0 || sx >= f.rw || sy < 0 || sy >= f.rh) continue;  // in_bounds
    const size_t q = static_cast<size_t>(sy) * f.rw + sx;
    const float sample_depth = ld(depth_all, q);
    const float ratio = depth / (sample_depth == 0.f ? kDepthGuard : sample_depth);
    if (!(ratio >= kRatioLow && ratio <= kRatioHigh)) continue;
    const float q_count = ld(grid.count, q);
    if (!(q_count >= kEpsilon)) continue;
    if (!(dot3(n, ld3(grid.visible_normal, q)) >= kNormalCos)) continue;
    const V3 q_sample = ld4xyz(grid.sample_position, q);
    const V3 dir = safe_normalize(sub3(q_sample, pos));
    if (!(dot3(dir, n) >= 0.f)) continue;
    bool occluded = false;
    for (int j = 0; j < tab.march_count[t] && !occluded; ++j) {
      const int ty = wrap(y + tab.march[t][k][j][0], f.rh);
      const int tx = wrap(x + tab.march[t][k][j][1], f.rw);
      const float tap_depth = ld(depth_all, static_cast<size_t>(ty) * f.rw + tx);
      const float ref_depth = depth + (sample_depth - depth) * tab.march_frac[t][j];
      occluded = tap_depth > ref_depth + kMarchBias;
    }
    if (occluded) continue;

    // Accepted: merge_reservoir(r, q, target / jacobian).
    float q_rad[4], q_rnd[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      q_rad[c] = ld(grid.radiance, 4 * q + c);
      q_rnd[c] = ld(grid.random, 4 * q + c);
    }
    const float q_hit = ld(grid.sample_position, 4 * q + 3);
    const V3 q_visible = ld4xyz(grid.visible_position, q);
    const V3 q_normal = ld3(grid.sample_normal, q);
    const float jac = q_hit > 0.5f ? jacobian(q_visible, q_sample, q_normal, pos) : 1.f;
    const float target = tab.emissive ? luminance(q_rad[0], q_rad[1], q_rad[2])
                                      : shade_luminance(b, n, dir, q_rad);
    const float w_new = target / jac * ld(grid.w, q) * q_count;
    const float new_w_sum = w_sum + w_new;
    w2_sum = w2_sum + w_new * w_new;
    const float s = sum4(q_rnd[0], q_rnd[1], q_rnd[2], q_rnd[3]);
    const float rand = s - floorf(s);
    const bool take = rand < w_new / (new_w_sum == 0.f ? 1.f : new_w_sum);
    w_sum = new_w_sum;
    count = count + q_count;
    if (take) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        rad[c] = q_rad[c];
        rnd[c] = q_rnd[c];
        vis_pos[c] = ld(grid.visible_position, 4 * q + c);
      }
      smp_pos[0] = q_sample.x;
      smp_pos[1] = q_sample.y;
      smp_pos[2] = q_sample.z;
      smp_pos[3] = q_hit;
      vis_n = ld3(grid.visible_normal, q);
      smp_n = q_normal;
      inst = __ldg(grid.visible_instance + q);
      win = static_cast<int>(q);
    }
  }

#pragma unroll
  for (int c = 0; c < 4; ++c) {
    out.radiance[4 * p + c] = rad[c];
    out.random[4 * p + c] = rnd[c];
    out.visible_position[4 * p + c] = vis_pos[c];
    out.sample_position[4 * p + c] = smp_pos[c];
  }
  out.visible_normal[3 * p] = vis_n.x;
  out.visible_normal[3 * p + 1] = vis_n.y;
  out.visible_normal[3 * p + 2] = vis_n.z;
  out.sample_normal[3 * p] = smp_n.x;
  out.sample_normal[3 * p + 1] = smp_n.y;
  out.sample_normal[3 * p + 2] = smp_n.z;
  out.visible_instance[p] = inst;
  out.count[p] = count;
  out.w_sum[p] = w_sum;
  out.w2_sum[p] = w2_sum;
  winner[p] = win;
}

}  // namespace

// r_in: the block's running reservoir (lh, lw); grid: the gathered temporal
// grid (rh, rw); depth_all (rh, rw); out: the block's new reservoir
// (sample fields, count, w_sum, w2_sum); winner (lh, lw) i32. Returns a
// cudaError_t.
extern "C" int hikari_spatial_reuse(SpatialReservoir r_in, SpatialReservoir grid,
                                    const float* depth_all, SpatialPixels px, SpatialTaps taps,
                                    SpatialFrame frame, SpatialReservoir out, int* winner,
                                    void* stream) {
  if (frame.lh <= 0 || frame.lw <= 0) return static_cast<int>(cudaSuccess);
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid_dim((frame.lw + kBlockX - 1) / kBlockX, (frame.lh + kBlockY - 1) / kBlockY);
  spatial_reuse_kernel<<<grid_dim, block, 0, static_cast<cudaStream_t>(stream)>>>(
      r_in, grid, depth_all, px, taps, frame, out, winner);
  return static_cast<int>(cudaGetLastError());
}

// sizeof(SpatialTaps): the wrapper holds its ctypes copy of the layout to it.
extern "C" int hikari_spatial_taps_bytes() { return static_cast<int>(sizeof(SpatialTaps)); }

extern "C" const char* hikari_spatial_reuse_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
