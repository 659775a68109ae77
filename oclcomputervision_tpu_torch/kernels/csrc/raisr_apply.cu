// RAISR per-pixel filter select and apply in parity-plane space.
//
// Replaces the TPU kernel oclcomputervision_tpu/ops/pallas/raisr_pallas.py,
// _apply_phase (body _make_kernel; wrapper apply_filters_planes).
//
// Output pixel (y, x) of phase t = (py, px) of image n:
//   out = sum_q bf16(tap_q) * bf16(bank[t][bucket][q]),  q = ti*fl + tj,
// where tap_q is plane ((py - m + ti) mod s, (px - m + tj) mod s) at plane
// (y + hp + floor((py - m + ti)/s), x + hp + floor((px - m + tj)/s)) and
// bucket = buckets[n % B][t][y][x]: colour channels stacked into the batch
// share the luma bucket map. bf16 x bf16 products are exact in f32, so the
// only freedom is the summation order; the plain PyTorch version and this
// kernel both sum q = 0..fl*fl-1 in order. A bucket outside [0, nbucket)
// selects nothing and gives 0, as the TPU kernel's one-hot select does.
//
// The TPU form computes all 216 bucket responses as one [224,128] @ [128, N]
// matrix-unit product and then a one-hot select: 216x the useful work, which
// pays on a TPU's matrix unit and not here. This is the direct select.
//
// What bounds it on the H100: per HR pixel 121 shared-memory tap reads, 121
// bank taps and 121 FMAs, against 4 bytes of bucket in and 4 bytes out: the
// instruction issue of the tap loop, not device memory.
// Design: one block per 16x32 plane tile of one image, all s*s phases. It
// stages the s*s planes of its tile plus the 2*hp halo in shared memory as
// bf16 (rounded once per element, then read by up to 121 taps); one thread
// per output pixel and phase. The scale and filter length are template
// constants, so each tap costs one shared-memory load, one add of two
// precomputed offsets and one FMA. A phase's bank in bf16 (216 x 121 x 2 =
// 52,272 bytes) is above the 48 KB static shared-memory limit, so filter
// rows are read from device memory through the read-only cache, 16 bytes (8
// taps) per load, where the whole bank (209 KB at x2) stays hot in L1/L2.
// One launch covers every image and phase.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileH = 16;  // plane rows per block
constexpr int kTileW = 32;  // plane columns per block

// S (scale) and FL (filter length) are compile-time, so every tap's plane
// and offset arithmetic folds away and the tap loops unroll fully.
template <int S, int FL>
__global__ void __launch_bounds__(kThreads) raisr_apply_kernel(
    const float* __restrict__ planes, const int* __restrict__ buckets,
    const uint4* __restrict__ bank, float* __restrict__ out, int nb, int hp,
    int rows, int wq, int h2p, int w2p, int nbucket) {
  constexpr int kSS = S * S;
  constexpr int kM = FL / 2;
  constexpr int kTaps = FL * FL;
  constexpr int kVecs = (kTaps + 7) / 8;  // 16-byte bank loads per row
  extern __shared__ unsigned short taps[];  // bf16 bits [S*S][eh][ew]
  const int eh = kTileH + 2 * hp;
  const int ew = kTileW + 2 * hp;
  const int n = blockIdx.z;
  const int i0 = blockIdx.y * kTileH;
  const int j0 = blockIdx.x * kTileW;
  const float* img = planes + static_cast<size_t>(n) * kSS * rows * wq;

  for (int e = threadIdx.x; e < kSS * eh * ew; e += blockDim.x) {
    const int p = e / (eh * ew);
    const int rem = e - p * eh * ew;
    const int y = rem / ew;
    const int x = rem - y * ew;
    const int r = i0 + y;
    const int c = j0 + x;
    const float v = (r < rows && c < wq)
                        ? img[(static_cast<size_t>(p) * rows + r) * wq + c]
                        : 0.0f;
    taps[e] = __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
  __syncthreads();

  const size_t plane_px = static_cast<size_t>(h2p) * w2p;
  const int* bmap = buckets + static_cast<size_t>(n % nb) * kSS * plane_px;
  float* omap = out + static_cast<size_t>(n) * kSS * plane_px;
  // a warp's 32 pixels share one phase (kTileH * kTileW per phase)
  for (int e = threadIdx.x; e < kSS * kTileH * kTileW; e += blockDim.x) {
    const int t = e / (kTileH * kTileW);
    const int rem = e - t * kTileH * kTileW;
    const int ii = rem / kTileW;
    const int jj = rem - ii * kTileW;
    const int gi = i0 + ii;
    const int gj = j0 + jj;
    if (gi >= h2p || gj >= w2p) continue;
    const int py = t / S;
    const int px = t - py * S;
    const size_t o = static_cast<size_t>(t) * plane_px +
                     static_cast<size_t>(gi) * w2p + gj;
    const int k = bmap[o];
    float acc = 0.0f;
    if (k >= 0 && k < nbucket) {
      // tap (ti, tj) reads plane (a, b) at shared-memory row y, column x;
      // the element index a*S*eh*ew + y*ew + b*eh*ew + x splits into a
      // row part and a column part (shifts by S*kM keep / and % >= 0)
      int rbase[FL];
      int cbase[FL];
#pragma unroll
      for (int u = 0; u < FL; ++u) {
        const int kr = py - kM + u + S * kM;
        rbase[u] = (kr % S) * S * eh * ew + (ii + hp + kr / S - kM) * ew;
        const int kc = px - kM + u + S * kM;
        cbase[u] = (kc % S) * eh * ew + jj + hp + kc / S - kM;
      }
      const uint4* wrow = bank + (static_cast<size_t>(t) * nbucket + k) * kVecs;
#pragma unroll
      for (int v = 0; v < kVecs; ++v) {
        const uint4 pk = __ldg(wrow + v);
        const unsigned int words[4] = {pk.x, pk.y, pk.z, pk.w};
#pragma unroll
        for (int h = 0; h < 8; ++h) {
          const int q = v * 8 + h;  // taps summed in order q = 0 .. kTaps-1
          if (q < kTaps) {
            const unsigned int word = words[h >> 1];
            const float wt = __uint_as_float((h & 1) ? (word & 0xffff0000u) : (word << 16));
            const float tap = __uint_as_float(
                static_cast<unsigned int>(taps[rbase[q / FL] + cbase[q % FL]]) << 16);
            acc = fmaf(tap, wt, acc);
          }
        }
      }
    }
    omap[o] = acc;
  }
}

template <int S, int FL>
cudaError_t launch(const float* planes, const int* buckets, const void* bank,
                   float* out, int nimg, int nb, int hp, int rows, int wq,
                   int h2p, int w2p, int nbucket, cudaStream_t stream) {
  const size_t smem = sizeof(unsigned short) * S * S * (kTileH + 2 * hp) *
                      (kTileW + 2 * hp);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        raisr_apply_kernel<S, FL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((w2p + kTileW - 1) / kTileW, (h2p + kTileH - 1) / kTileH, nimg);
  raisr_apply_kernel<S, FL><<<grid, kThreads, smem, stream>>>(
      planes, buckets, static_cast<const uint4*>(bank), out, nb, hp, rows, wq,
      h2p, w2p, nbucket);
  return cudaGetLastError();
}

}  // namespace

// bank: per phase and bucket, fl*fl bf16 taps padded to a multiple of 8
// (row_stride), 16-byte aligned. Built for fl = 11 at scales 2, 3 and 4
// (every bank the repository ships); anything else is refused.
extern "C" int ocvk_raisr_apply(const float* planes, const int* buckets,
                                const void* bank, float* out, int nimg,
                                int nb, int s, int fl, int hp, int rows,
                                int wq, int h2p, int w2p, int nbucket,
                                int row_stride, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fl != 11 || row_stride != (fl * fl + 7) / 8 * 8)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (s) {
    case 2:
      err = launch<2, 11>(planes, buckets, bank, out, nimg, nb, hp, rows, wq,
                          h2p, w2p, nbucket, st);
      break;
    case 3:
      err = launch<3, 11>(planes, buckets, bank, out, nimg, nb, hp, rows, wq,
                          h2p, w2p, nbucket, st);
      break;
    case 4:
      err = launch<4, 11>(planes, buckets, bank, out, nimg, nb, hp, rows, wq,
                          h2p, w2p, nbucket, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
