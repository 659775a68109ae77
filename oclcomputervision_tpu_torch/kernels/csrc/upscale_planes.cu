// Cheap bilinear (align-corners) upscale straight into s*s parity planes.
//
// Replaces the TPU kernel oclcomputervision_tpu/ops/pallas/upscale_pallas.py,
// upscale_planes_pallas (body _make_upscale_kernel).
//
// Output plane (a*s + b) element (i, j) is a separable 2-tap stencil with
// per-row and per-column constant weights (ops/raisr.py _phase_stencil_taps):
// a vertical pass, then a horizontal pass, source indices clamped to the image
// (edge replication outside it). The host hands over one compact table per
// axis: for every phase and plane index the two source indices (already
// clamped, first <= second) and their two weights.
//
// What bounds it on the H100: device memory. Per image it reads the f32 LR
// image once and writes s*s planes of hq*wq f32 (at 16 x 1024^2 LR, x2:
// 67 MB in, 304 MB out; 0.111 ms at 3.35 TB/s), and does a few flops per
// element.
//
// Design: a block of 128 threads owns a tile of 8 plane rows x 128 plane
// columns of one image and writes all s*s phases of it (small blocks: many
// are in flight per SM and a block's two barriers cost little).
//  - It stages the <= 12 x 132 LR pixels the tile reaches in shared memory
//    with coalesced loads; the edge clamp is resolved here, once.
//  - Vertical pass once per (row phase a, plane row, LR column), into shared
//    memory: one warp per (a, row), its two row weights and indices read once.
//  - Horizontal pass: a thread owns four consecutive plane columns, reads
//    their column indices and weights once per column phase b as 16-byte
//    loads, and for every (a, row) of its warp reads two vertical values per
//    column from shared memory and writes one 16-byte streaming store (a
//    warp writes 512 contiguous bytes).
//  - One grid dimension over (image, tile row, tile column), 32-bit indices
//    inside a tile.
//  - Scales 2-4 are compiled (S a template constant). Any other scale runs
//    upscale_planes_generic_kernel: the same body with the scale read at
//    run time and the vertical buffer (S x 4.2 KB) in dynamic shared
//    memory, counted apart (upscale_planes_generic). It is a separate
//    function so that the compiled forms' code stays as it was measured.
//
// Numerics: the plain PyTorch version sums, over the phase's sorted offsets,
// w_d[i] * x[clamp(i + d)] into a zero accumulator, every product and sum
// rounded separately. At any one element at most two offsets carry a non-zero
// weight. For this function's inputs (finite, in [0, 1], weights >= 0) a
// zero-weight term is 0 * x = +0 and v + 0 = v, and the first non-zero term
// is 0 + p = p, so the sum equals w_lo * x_lo + w_hi * x_hi with the two
// non-zero taps in offset order, which is what this kernel computes (the
// library builds with -fmad=false, so nothing is contracted). The kernel
// therefore still equals the plain version bit for bit; against the JAX twin,
// which contracts into FMAs, the contract stays 1 ULP.
//
// Measured at 16 x 1024^2 LR, x2, on an NVIDIA H100 80GB HBM3 at 700 W
// (chip_smoke.py): 0.16 ms, 1.45x the bytes bound, against 0.37 ms for
// F.interpolate(align_corners=True) and 1.22 ms for the earlier form (one
// thread per element walking every offset of the phase). With 16-row tiles,
// 256 threads and plain stores it took 0.207 ms.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTileH = 8;    // plane rows per block
constexpr int kTileW = 128;  // plane columns per block
// LR rows and columns a tile can reach: consecutive plane indices advance the
// source by less than one pixel, the s phases and the second tap add < 3 (the
// host checks every tile of its tables against these)
constexpr int kSpanH = kTileH + 4;
constexpr int kSpanW = kTileW + 4;

// Tables, per axis: idx[(k*S + phase)*n + i] and wgt[...] for tap k in {0, 1}.
template <int S>
__global__ void __launch_bounds__(kThreads) upscale_planes_kernel(
    const float* __restrict__ x, float* __restrict__ out,
    const int* __restrict__ ridx, const float* __restrict__ rw,
    const int* __restrict__ cidx, const float* __restrict__ cw, int h, int w,
    int hq, int wq, int tiles_y, int tiles_x) {
  __shared__ float xs[kSpanH][kSpanW];
  __shared__ float vs[S][kTileH][kSpanW];
  int bid = blockIdx.x;
  const int tj = bid % tiles_x;
  bid /= tiles_x;
  const int ti = bid % tiles_y;
  const int n = bid / tiles_y;
  const int i0 = ti * kTileH;
  const int j0 = tj * kTileW;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // first source row and column of the tile: indices do not decrease along
  // an axis and the first tap is the lower one
  int rmin = ridx[i0];
  int cmin = cidx[j0];
#pragma unroll
  for (int a = 1; a < S; ++a) {
    rmin = min(rmin, ridx[a * hq + i0]);
    cmin = min(cmin, cidx[a * wq + j0]);
  }

  const float* img = x + static_cast<size_t>(n) * h * w;
  for (int e = threadIdx.x; e < kSpanH * kSpanW; e += kThreads) {
    const int y = e / kSpanW;
    const int c = e - y * kSpanW;
    xs[y][c] = img[min(rmin + y, h - 1) * w + min(cmin + c, w - 1)];
  }
  __syncthreads();

  // vertical pass, shared by every column phase
  for (int r = warp; r < S * kTileH; r += kWarps) {
    const int a = r / kTileH;
    const int ii = r - a * kTileH;
    const int i = min(i0 + ii, hq - 1);
    const int y0 = ridx[a * hq + i] - rmin;
    const int y1 = ridx[(S + a) * hq + i] - rmin;
    const float w0 = rw[a * hq + i];
    const float w1 = rw[(S + a) * hq + i];
    for (int c = lane; c < kSpanW; c += 32)
      vs[a][ii][c] = w0 * xs[y0][c] + w1 * xs[y1][c];
  }
  __syncthreads();

  // horizontal pass: four consecutive plane columns per thread
  const int j = j0 + 4 * lane;
  if (j >= wq) return;
  float* obase = out + static_cast<size_t>(n) * S * S * hq * wq + j;
#pragma unroll
  for (int b = 0; b < S; ++b) {
    int4 c0 = *reinterpret_cast<const int4*>(cidx + b * wq + j);
    int4 c1 = *reinterpret_cast<const int4*>(cidx + (S + b) * wq + j);
    const float4 u0 = *reinterpret_cast<const float4*>(cw + b * wq + j);
    const float4 u1 = *reinterpret_cast<const float4*>(cw + (S + b) * wq + j);
    c0.x -= cmin; c0.y -= cmin; c0.z -= cmin; c0.w -= cmin;
    c1.x -= cmin; c1.y -= cmin; c1.z -= cmin; c1.w -= cmin;
    for (int r = warp; r < S * kTileH; r += kWarps) {
      const int a = r / kTileH;
      const int ii = r - a * kTileH;
      const int i = i0 + ii;
      if (i >= hq) continue;
      const float* v = vs[a][ii];
      float4 o;
      o.x = u0.x * v[c0.x] + u1.x * v[c1.x];
      o.y = u0.y * v[c0.y] + u1.y * v[c1.y];
      o.z = u0.z * v[c0.z] + u1.z * v[c1.z];
      o.w = u0.w * v[c0.w] + u1.w * v[c1.w];
      // streaming store: the planes pass through L2 once
      __stcs(reinterpret_cast<float4*>(
                 obase + (static_cast<size_t>(a * S + b) * hq + i) * wq),
             o);
    }
  }
}

// The generic form: scale S at run time, the vertical buffer [S][kTileH][kSpanW]
// in dynamic shared memory.
__global__ void __launch_bounds__(kThreads) upscale_planes_generic_kernel(
    const float* __restrict__ x, float* __restrict__ out,
    const int* __restrict__ ridx, const float* __restrict__ rw,
    const int* __restrict__ cidx, const float* __restrict__ cw, int h, int w,
    int hq, int wq, int tiles_y, int tiles_x, int S) {
  __shared__ float xs[kSpanH][kSpanW];
  extern __shared__ float vs_dyn[];
  float(*vs)[kTileH][kSpanW] = reinterpret_cast<float(*)[kTileH][kSpanW]>(vs_dyn);
  int bid = blockIdx.x;
  const int tj = bid % tiles_x;
  bid /= tiles_x;
  const int ti = bid % tiles_y;
  const int n = bid / tiles_y;
  const int i0 = ti * kTileH;
  const int j0 = tj * kTileW;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // first source row and column of the tile: indices do not decrease along
  // an axis and the first tap is the lower one
  int rmin = ridx[i0];
  int cmin = cidx[j0];
  for (int a = 1; a < S; ++a) {
    rmin = min(rmin, ridx[a * hq + i0]);
    cmin = min(cmin, cidx[a * wq + j0]);
  }

  const float* img = x + static_cast<size_t>(n) * h * w;
  for (int e = threadIdx.x; e < kSpanH * kSpanW; e += kThreads) {
    const int y = e / kSpanW;
    const int c = e - y * kSpanW;
    xs[y][c] = img[min(rmin + y, h - 1) * w + min(cmin + c, w - 1)];
  }
  __syncthreads();

  // vertical pass, shared by every column phase
  for (int r = warp; r < S * kTileH; r += kWarps) {
    const int a = r / kTileH;
    const int ii = r - a * kTileH;
    const int i = min(i0 + ii, hq - 1);
    const int y0 = ridx[a * hq + i] - rmin;
    const int y1 = ridx[(S + a) * hq + i] - rmin;
    const float w0 = rw[a * hq + i];
    const float w1 = rw[(S + a) * hq + i];
    for (int c = lane; c < kSpanW; c += 32)
      vs[a][ii][c] = w0 * xs[y0][c] + w1 * xs[y1][c];
  }
  __syncthreads();

  // horizontal pass: four consecutive plane columns per thread
  const int j = j0 + 4 * lane;
  if (j >= wq) return;
  float* obase = out + static_cast<size_t>(n) * S * S * hq * wq + j;
  for (int b = 0; b < S; ++b) {
    int4 c0 = *reinterpret_cast<const int4*>(cidx + b * wq + j);
    int4 c1 = *reinterpret_cast<const int4*>(cidx + (S + b) * wq + j);
    const float4 u0 = *reinterpret_cast<const float4*>(cw + b * wq + j);
    const float4 u1 = *reinterpret_cast<const float4*>(cw + (S + b) * wq + j);
    c0.x -= cmin; c0.y -= cmin; c0.z -= cmin; c0.w -= cmin;
    c1.x -= cmin; c1.y -= cmin; c1.z -= cmin; c1.w -= cmin;
    for (int r = warp; r < S * kTileH; r += kWarps) {
      const int a = r / kTileH;
      const int ii = r - a * kTileH;
      const int i = i0 + ii;
      if (i >= hq) continue;
      const float* v = vs[a][ii];
      float4 o;
      o.x = u0.x * v[c0.x] + u1.x * v[c1.x];
      o.y = u0.y * v[c0.y] + u1.y * v[c1.y];
      o.z = u0.z * v[c0.z] + u1.z * v[c1.z];
      o.w = u0.w * v[c0.w] + u1.w * v[c1.w];
      // streaming store: the planes pass through L2 once
      __stcs(reinterpret_cast<float4*>(
                 obase + (static_cast<size_t>(a * S + b) * hq + i) * wq),
             o);
    }
  }
}


template <int S>
cudaError_t launch(const float* x, float* out, const int* ridx,
                   const float* rw, const int* cidx, const float* cw, int nimg,
                   int h, int w, int hq, int wq, cudaStream_t stream) {
  const int tiles_y = (hq + kTileH - 1) / kTileH;
  const int tiles_x = (wq + kTileW - 1) / kTileW;
  const long long blocks = static_cast<long long>(nimg) * tiles_y * tiles_x;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  upscale_planes_kernel<S><<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
      x, out, ridx, rw, cidx, cw, h, w, hq, wq, tiles_y, tiles_x);
  return cudaGetLastError();
}

cudaError_t launch_generic(const float* x, float* out, const int* ridx, const float* rw,
                           const int* cidx, const float* cw, int nimg, int h, int w, int s,
                           int hq, int wq, cudaStream_t stream) {
  const int tiles_y = (hq + kTileH - 1) / kTileH;
  const int tiles_x = (wq + kTileW - 1) / kTileW;
  const long long blocks = static_cast<long long>(nimg) * tiles_y * tiles_x;
  const size_t dyn = sizeof(float) * s * kTileH * kSpanW;
  if (blocks > 2147483647LL || dyn + sizeof(float) * kSpanH * kSpanW > 227 * 1024)
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      upscale_planes_generic_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(dyn));
  if (err != cudaSuccess) return err;
  upscale_planes_generic_kernel<<<static_cast<unsigned int>(blocks), kThreads, dyn, stream>>>(
      x, out, ridx, rw, cidx, cw, h, w, hq, wq, tiles_y, tiles_x, s);
  return cudaGetLastError();
}

}  // namespace

// ridx, rw: [2, s, hq]; cidx, cw: [2, s, wq] (tap, phase, plane index), wq a
// multiple of 4. tile_h, tile_w, span_h, span_w: the tile geometry the host
// checked its tables against; refused unless it is this file's. Scales 2, 3
// and 4 are compiled; any other scale >= 1 runs the generic form.
extern "C" int ocvk_upscale_planes(const float* x, float* out, const int* ridx,
                                   const float* rw, const int* cidx,
                                   const float* cw, int nimg, int h, int w,
                                   int s, int hq, int wq, int tile_h,
                                   int tile_w, int span_h, int span_w,
                                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile_h != kTileH || tile_w != kTileW || span_h != kSpanH ||
      span_w != kSpanW || wq % 4 != 0 || s < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (s) {
    case 2:
      err = launch<2>(x, out, ridx, rw, cidx, cw, nimg, h, w, hq, wq, st);
      break;
    case 3:
      err = launch<3>(x, out, ridx, rw, cidx, cw, nimg, h, w, hq, wq, st);
      break;
    case 4:
      err = launch<4>(x, out, ridx, rw, cidx, cw, nimg, h, w, hq, wq, st);
      break;
    default:
      err = launch_generic(x, out, ridx, rw, cidx, cw, nimg, h, w, s, hq, wq, st);
  }
  return static_cast<int>(err);
}
