// One round of the fast (warp-based) block matching: warp frame 1 by the
// current per-pixel displacement state, cost the 3x3 candidate shifts at
// {-step, 0, +step} as ps x ps box sums of |f0 - shifted warp| (or its
// square), take the first minimum in row-major (dy, dx) order and move the
// state by it. f0, f1 [B, H, W] uint8, state planes dy, dx [B, H, W] int32
// (null: all zero) -> new state planes. The 3x3 median that closes a round
// is me_fast_median.cu.
//
// Replaces, together with me_fast_median.cu, the TPU kernel
// me_fast_residual_pallas (oclcomputervision_tpu/ops/pallas/me_fast_pallas.py,
// body _make_fast_kernel). That kernel runs all rounds in one call on row
// bands with a 17-row halo recomputed per band, and warps by masked selects
// over rotated copies of the band, because the TPU has no per-pixel read;
// that needs the state bounded, so it only takes the residual form. Here a
// round is one launch, a thread reads frame 1 where the state points, and
// the state may be any displacement (the residual form starts it at zero on
// a frame already warped by the seed; the gather form starts it at the seed).
//
// Semantics: _fast_rounds of oclcomputervision_tpu/ops/motion.py. With
// w1(p) = f1(p + state(p)) inside the image and 0 outside (both for p and for
// where it points), candidate o costs sum over the patch offsets q with
// p + q inside the image of |f0(p + q) - w1(p + q + o)|.
//
// What bounds it on the H100: integer operations, 9 ps^2 taps per pixel (225
// at patch 5) against 2 bytes read, 8 of state read and 8 written. Every tap
// reads shared memory.
// Design: a block takes a 32 x 32 tile, 256 threads with 4 pixels each. It
// stages the warped frame for the tile plus a halo of step + ps/2 pixels,
// and frame 0 with a halo of ps/2, as bytes in shared memory (the warp is
// evaluated once per staged pixel, not once per tap); then each thread sums
// its nine costs over the part of its patch that lies inside the image.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;
constexpr int kRows = 8;  // thread rows; each thread takes kTile / kRows pixels

template <bool SSD>
__global__ void __launch_bounds__(kTile* kRows)
    me_fast_round_kernel(const uint8_t* __restrict__ f0, const uint8_t* __restrict__ f1,
                         const int* __restrict__ dy_in, const int* __restrict__ dx_in,
                         int* __restrict__ dy_out, int* __restrict__ dx_out, int h, int w, int pm,
                         int step) {
  extern __shared__ uint8_t smem[];
  const int halo = step + pm;
  const int ww = kTile + 2 * halo;  // warped tile width
  const int aw = kTile + 2 * pm;    // frame-0 tile width
  uint8_t* w1s = smem;
  uint8_t* f0s = smem + ww * ww;

  const size_t img = static_cast<size_t>(blockIdx.z) * h * w;
  f0 += img;
  f1 += img;
  const int x0 = blockIdx.x * kTile;
  const int y0 = blockIdx.y * kTile;
  const int tid = threadIdx.y * kTile + threadIdx.x;

  for (int i = tid; i < ww * ww; i += kTile * kRows) {
    const int y = y0 - halo + i / ww;
    const int x = x0 - halo + i % ww;
    uint8_t v = 0;
    if (y >= 0 && y < h && x >= 0 && x < w) {
      const size_t p = img + static_cast<size_t>(y) * w + x;
      const int sy = y + (dy_in != nullptr ? dy_in[p] : 0);
      const int sx = x + (dx_in != nullptr ? dx_in[p] : 0);
      if (sy >= 0 && sy < h && sx >= 0 && sx < w) v = __ldg(f1 + sy * w + sx);
    }
    w1s[i] = v;
  }
  for (int i = tid; i < aw * aw; i += kTile * kRows) {
    const int y = y0 - pm + i / aw;
    const int x = x0 - pm + i % aw;
    f0s[i] = (y >= 0 && y < h && x >= 0 && x < w) ? __ldg(f0 + y * w + x) : 0;
  }
  __syncthreads();

  const int lx = threadIdx.x;
  const int x = x0 + lx;
  if (x >= w) return;
  for (int ly = threadIdx.y; ly < kTile; ly += kRows) {
    const int y = y0 + ly;
    if (y >= h) return;
    int cost[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
    for (int qy = -pm; qy <= pm; ++qy) {
      if (y + qy < 0 || y + qy >= h) continue;  // the difference is zero outside the image
      for (int qx = -pm; qx <= pm; ++qx) {
        if (x + qx < 0 || x + qx >= w) continue;
        const int a = f0s[(ly + pm + qy) * aw + lx + pm + qx];
        const uint8_t* c = w1s + (ly + halo + qy) * ww + lx + halo + qx;
#pragma unroll
        for (int k = 0; k < 9; ++k) {
          const int d = a - static_cast<int>(c[(k / 3 - 1) * step * ww + (k % 3 - 1) * step]);
          cost[k] += SSD ? d * d : abs(d);
        }
      }
    }
    int best = INT_MAX, best_k = 0;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      if (cost[k] < best) {  // strict: the first minimum in (dy, dx) order wins
        best = cost[k];
        best_k = k;
      }
    }
    const size_t p = img + static_cast<size_t>(y) * w + x;
    dy_out[p] = (dy_in != nullptr ? dy_in[p] : 0) + (best_k / 3 - 1) * step;
    dx_out[p] = (dx_in != nullptr ? dx_in[p] : 0) + (best_k % 3 - 1) * step;
  }
}

}  // namespace

// dy_in and dx_in may both be null (a state of zeros). The block's shared
// memory grows with step and ps; a geometry that exceeds the card's limit is
// refused with cudaErrorInvalidValue.
extern "C" int ocvk_me_fast_round(const uint8_t* f0, const uint8_t* f1, const int* dy_in,
                                  const int* dx_in, int* dy_out, int* dx_out, int nimg, int h,
                                  int w, int ps, int step, int ssd, void* stream) {
  if (ps < 1 || ps % 2 == 0 || step < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int pm = ps / 2;
  const int ww = kTile + 2 * (step + pm);
  const int aw = kTile + 2 * pm;
  const size_t bytes = static_cast<size_t>(ww) * ww + static_cast<size_t>(aw) * aw;
  if (bytes > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = ssd ? me_fast_round_kernel<true> : me_fast_round_kernel<false>;
  if (bytes > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const dim3 block(kTile, kRows);
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile, nimg);
  kernel<<<grid, block, bytes, static_cast<cudaStream_t>(stream)>>>(
      f0, f1, dy_in, dx_in, dy_out, dx_out, h, w, pm, step);
  return static_cast<int>(cudaGetLastError());
}
