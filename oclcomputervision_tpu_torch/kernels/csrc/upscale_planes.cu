// Cheap bilinear (align-corners) upscale straight into s*s parity planes.
//
// Replaces the TPU kernel oclcomputervision_tpu/ops/pallas/upscale_pallas.py,
// upscale_planes_pallas (body _make_upscale_kernel).
//
// Output plane (a*s + b) element (i, j) is a separable 2-tap shift stencil
// with per-row and per-column constant weights (ops/raisr.py
// _phase_stencil_taps): a vertical pass over the phase's sorted row offsets,
// then a horizontal pass over its sorted column offsets, source indices
// clamped to the image (edge replication outside it). The tables come from
// the host as small device arrays.
//
// What bounds it on the H100: device memory. Per image it reads the f32 LR
// image once and writes s*s planes of hq*wq f32 (at 1024^2 LR, x2: 4 MB in,
// 19 MB out), and does a few flops per element.
// Design: one thread per plane column and 8 plane rows, consecutive threads
// on consecutive plane columns, so the writes coalesce; the <= 6x6 source
// taps of an element hit L1/L2 (neighbouring threads read neighbouring LR
// pixels).
//
// Numerics: every product and sum is rounded separately (the library builds
// with -fmad=false) in the plain PyTorch version's order, so the kernel
// matches it bit for bit; the JAX twin contracts into FMAs, hence the
// package's 1-ULP contract against JAX.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 8;  // plane rows per thread

__global__ void __launch_bounds__(kThreads) upscale_planes_kernel(
    const float* __restrict__ x, float* __restrict__ out,
    const int* __restrict__ row_off, const int* __restrict__ row_n,
    const float* __restrict__ row_w, const int* __restrict__ col_off,
    const int* __restrict__ col_n, const float* __restrict__ col_w, int h,
    int w, int s, int hq, int wq, int nd) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= wq) return;
  const int ss = s * s;
  const int n = blockIdx.z / ss;
  const int p = blockIdx.z - n * ss;
  const int a = p / s;
  const int b = p - a * s;
  const float* img = x + static_cast<size_t>(n) * h * w;
  const int nr = row_n[a];
  const int nc = col_n[b];
  const int i_end = min(hq, static_cast<int>(blockIdx.y + 1) * kRows);

  for (int i = blockIdx.y * kRows; i < i_end; ++i) {
    float o = 0.0f;
    for (int kc = 0; kc < nc; ++kc) {
      const int c = min(max(j + col_off[b * nd + kc], 0), w - 1);
      float v = 0.0f;
      for (int kr = 0; kr < nr; ++kr) {
        const int r = min(max(i + row_off[a * nd + kr], 0), h - 1);
        v = v + row_w[(static_cast<size_t>(a) * nd + kr) * hq + i] *
                    img[static_cast<size_t>(r) * w + c];
      }
      o = o + col_w[(static_cast<size_t>(b) * nd + kc) * wq + j] * v;
    }
    out[(static_cast<size_t>(blockIdx.z) * hq + i) * wq + j] = o;
  }
}

}  // namespace

extern "C" int ocvk_upscale_planes(const float* x, float* out,
                                   const int* row_off, const int* row_n,
                                   const float* row_w, const int* col_off,
                                   const int* col_n, const float* col_w,
                                   int nimg, int h, int w, int s, int hq,
                                   int wq, int nd, void* stream) {
  const dim3 grid((wq + kThreads - 1) / kThreads, (hq + kRows - 1) / kRows,
                  nimg * s * s);
  upscale_planes_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, row_off, row_n, row_w, col_off, col_n, col_w, h, w, s, hq, wq,
      nd);
  return static_cast<int>(cudaGetLastError());
}
