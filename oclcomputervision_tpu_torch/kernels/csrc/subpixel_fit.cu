// The subpixel fit of a flow: per pixel, the patch cost at the flow rounded
// half to even and at its four axis neighbours, then a 1-D fit per axis.
// g0, g1 [B, H, W] uint8 frames, flow [B, H, W, 2] float32 (u, v
// interleaved) -> a new flow of the same shape.
//
// Replaces no TPU kernel: the JAX package's refine_flow_subpixel
// (oclcomputervision_tpu/ops/motion.py) is plain jnp. Its PyTorch port
// (kernels/motion.subpixel_fit, kept as the plain version for CPU tensors)
// ran five gathers, five separable box sums and the fit's elementwise tail
// as about 240 torch launches a fit; the hybrid pyramid's 36 fits a call
// were most of its host time.
//
// Semantics, equal to the plain version bit for bit:
// - iu, iv: the flow rounded half to even (rintf); each pixel q uses its own.
// - For each shift (dy, dx) in (0, 0), (0, -1), (0, +1), (-1, 0), (+1, 0):
//   the difference at q is f0[q] - g1[q + (iv(q) + dy, iu(q) + dx)], a g1
//   read outside the frame giving 0; |d| for SAD, d * d for SSD.
// - The cost at p is the patch sum of those, in integers; patch positions
//   outside the frame add 0. It is converted to float32 rounded to nearest.
// - The deltas in float32 with the plain version's operations and order:
//   no FMA (the library builds with -fmad=false), IEEE division (no
//   reciprocal), the clamp to 1e-12, the interior-minimum test, the clamp
//   to [-0.5, 0.5], and float(iu) + du (float(iu) is +0.0 for a rounded
//   -0.0).
// Flows are assumed finite.
//
// What bounds it on the H100: the bytes, about 22 a flow vector (the flow
// and f0 read, g1 five times through L1, the flow written): 8 us at
// 4 x 480 x 640. It is there to take the fit's launches off the host.
//
// Design: a block of 32 x 8 threads writes a tile of 16 x 32 outputs. Each
// thread first computes, for the tile and its halo (patch / 2 on each side),
// the five differences of one pixel at a time from its own displacement and
// stages them in shared memory as uint16 (at most 255^2); halo pixels are
// computed again by each block that reads them. The displacements vary per
// pixel and reach tens of pixels, so no fixed g1 tile holds them: g1 is read
// from device memory through L1. Then the column sums of each plane (the
// tile's rows, the halo's columns) in uint32, then the row sums at each
// output, then the fit. Both sums are integer, so their order is free.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;
constexpr int kThreads = kThreadsX * kThreadsY;
constexpr int kTileW = 32;  // output columns a block
constexpr int kTileH = 16;  // output rows a block
constexpr int kShifts = 5;
constexpr int kMaxPatch = 31;          // kernels/motion.SUBPIXEL_MAX_PATCH
constexpr int kMaxSmem = 48 * 1024;    // a block's dynamic shared memory without an opt-in
constexpr float kFlowCap = 2147483648.0f;  // |rounded flow| past any frame (h * w < 2^31)

// The five shifts (dy, dx) in the plain version's order: c0, cxm, cxp, cym, cyp.
__device__ __forceinline__ int shift_dy(int s) { return s == 3 ? -1 : (s == 4 ? 1 : 0); }
__device__ __forceinline__ int shift_dx(int s) { return s == 1 ? -1 : (s == 2 ? 1 : 0); }

// A flow component rounded half to even, as an integer; past +-2^31 every
// read is outside the frame, as it is for the plain version's int64.
__device__ __forceinline__ long long displacement(float f) {
  return static_cast<long long>(fminf(fmaxf(rintf(f), -kFlowCap), kFlowCap));
}

__host__ __device__ constexpr int staged_cols(int ps) { return kTileW + ps - 1; }
__host__ __device__ constexpr int staged_rows(int ps) { return kTileH + ps - 1; }

// Bytes of a block's shared memory: the five difference planes of the tile
// and its halo (uint16), then their column sums over the tile's rows (uint32).
__host__ __device__ constexpr int diff_bytes(int ps) {
  return (kShifts * staged_rows(ps) * staged_cols(ps) * 2 + 3) / 4 * 4;
}
__host__ __device__ constexpr int smem_bytes(int ps) {
  return diff_bytes(ps) + kShifts * kTileH * staged_cols(ps) * 4;
}
static_assert(smem_bytes(kMaxPatch) <= kMaxSmem, "the largest patch must fit a block");

// One axis of the fit, as the plain version writes it.
__device__ __forceinline__ float delta(float cm, float cc, float cp, bool ssd) {
  float d;
  if (ssd) {  // quadratic near the minimum: the parabola fit
    const float denom = (cm + cp) - 2.0f * cc;
    d = denom > 0.0f ? (cm - cp) / fmaxf(2.0f * denom, 1e-12f) : 0.0f;
  } else {  // SAD of a translated signal is V-shaped: the equiangular fit
    d = (cm - cp) / fmaxf(2.0f * (fmaxf(cm, cp) - cc), 1e-12f);
  }
  d = (cm >= cc && cp >= cc) ? d : 0.0f;  // only an interior minimum
  return fminf(fmaxf(d, -0.5f), 0.5f);
}

__global__ void __launch_bounds__(kThreads)
    subpixel_fit_kernel(const uint8_t* __restrict__ g0, const uint8_t* __restrict__ g1,
                        const float* __restrict__ flow, float* __restrict__ out, int h, int w,
                        int ps, int ssd) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = staged_rows(ps), cols = staged_cols(ps), pm = ps / 2;
  const int plane = rows * cols;
  uint16_t* diff = reinterpret_cast<uint16_t*>(smem);                   // [5][rows][cols]
  uint32_t* colsum = reinterpret_cast<uint32_t*>(smem + diff_bytes(ps));  // [5][kTileH][cols]
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const size_t img = static_cast<size_t>(blockIdx.z) * h * w;
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;

  // the five differences of every staged pixel; 0 outside the frame
  for (int e = tid; e < plane; e += kThreads) {
    const int gy = y0 + e / cols - pm, gx = x0 + e % cols - pm;
    uint32_t d[kShifts] = {0, 0, 0, 0, 0};
    if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
      const size_t q = img + static_cast<size_t>(gy) * w + gx;
      const int a = __ldg(g0 + q);
      const long long iu = displacement(__ldg(flow + 2 * q));
      const long long iv = displacement(__ldg(flow + 2 * q + 1));
#pragma unroll
      for (int s = 0; s < kShifts; ++s) {
        const long long yy = gy + iv + shift_dy(s), xx = gx + iu + shift_dx(s);
        const int b = (yy >= 0 && yy < h && xx >= 0 && xx < w)
                          ? __ldg(g1 + img + static_cast<size_t>(yy) * w + static_cast<size_t>(xx))
                          : 0;
        const int v = a - b;
        d[s] = static_cast<uint32_t>(ssd ? v * v : (v < 0 ? -v : v));
      }
    }
#pragma unroll
    for (int s = 0; s < kShifts; ++s) diff[s * plane + e] = static_cast<uint16_t>(d[s]);
  }
  __syncthreads();

  // column sums over the patch's rows, at each of the tile's rows
  for (int e = tid; e < kTileH * cols; e += kThreads) {
    const int r = e / cols, c = e % cols;
#pragma unroll
    for (int s = 0; s < kShifts; ++s) {
      const uint16_t* src = diff + s * plane + r * cols + c;
      uint32_t acc = 0;
      for (int k = 0; k < ps; ++k) acc += src[k * cols];
      colsum[(s * kTileH + r) * cols + c] = acc;
    }
  }
  __syncthreads();

  // row sums of the column sums: the five costs of each output, then the fit
  for (int e = tid; e < kTileH * kTileW; e += kThreads) {
    const int r = e / kTileW, c = e % kTileW;
    const int y = y0 + r, x = x0 + c;
    if (y >= h || x >= w) continue;
    float cost[kShifts];
#pragma unroll
    for (int s = 0; s < kShifts; ++s) {
      const uint32_t* src = colsum + (s * kTileH + r) * cols + c;
      uint32_t acc = 0;
      for (int k = 0; k < ps; ++k) acc += src[k];
      cost[s] = __int2float_rn(static_cast<int>(acc));
    }
    const bool is_ssd = ssd != 0;
    const float du = delta(cost[1], cost[0], cost[2], is_ssd);
    const float dv = delta(cost[3], cost[0], cost[4], is_ssd);
    const size_t q = img + static_cast<size_t>(y) * w + x;
    // float(iu) of the plain version: the rounded flow, +0.0 for a -0.0
    const float ru = rintf(__ldg(flow + 2 * q)), rv = rintf(__ldg(flow + 2 * q + 1));
    out[2 * q] = (ru == 0.0f ? 0.0f : ru) + du;
    out[2 * q + 1] = (rv == 0.0f ? 0.0f : rv) + dv;
  }
}

}  // namespace

// Odd ps in [1, 31]; any other returns cudaErrorInvalidValue.
extern "C" int ocvk_subpixel_fit(const uint8_t* g0, const uint8_t* g1, const float* flow,
                                 float* out, int nimg, int h, int w, int ps, int ssd,
                                 void* stream) {
  if (ps < 1 || ps % 2 == 0 || ps > kMaxPatch) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kThreadsX, kThreadsY);
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, nimg);
  subpixel_fit_kernel<<<grid, block, smem_bytes(ps), static_cast<cudaStream_t>(stream)>>>(
      g0, g1, flow, out, h, w, ps, ssd);
  return static_cast<int>(cudaGetLastError());
}
