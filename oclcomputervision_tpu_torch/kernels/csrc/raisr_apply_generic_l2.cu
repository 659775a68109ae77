// RAISR per-pixel filter select and apply in parity-plane space, generic
// form for banks too large for shared memory: any scale and filter length,
// read at run time, the filter rows read through L1 and L2.
//
// Replaces, with raisr_apply.cu and raisr_apply_generic.cu, the TPU kernel
// oclcomputervision_tpu/ops/pallas/raisr_pallas.py, _apply_phase (body
// _make_kernel), which is written for any filter_len and scale.
// kernels/raisr.apply_form sends a config here only when one phase's bank
// and a minimal tile do not fit a block's shared memory (for example x2,
// filter length 17 and 432 buckets: 145 words x 432 rows = 250,560 bytes);
// the launches count as raisr_apply_generic_l2.
//
// Output pixel (y, x) of phase t = (py, px) of image n, as raisr_apply.cu:
//   out = sum_q bf16(tap_q) * bf16(bank[t][bucket][q]),  q = ti*fl + tj,
// tap_q from plane ((py - m + ti) mod s, (px - m + tj) mod s) at plane
// (y + hp + floor((py - m + ti)/s), x + hp + floor((px - m + tj)/s)),
// bucket = buckets[n % B][t][y][x]; q summed in order with one fmaf per tap
// (a bf16 x bf16 product is exact in f32), so it equals the plain version
// bit for bit. A bucket outside [0, nbucket) gives 0.
//
// What bounds it on the H100: fl*fl taps per pixel, each a plane load, a
// filter-row load and a fused multiply-add; the 32 lanes of a warp read 32
// different filter rows, so every row load is a scattered access.
// Design: one thread per output pixel, a block of 32 x 8 pixels of one phase
// of one image; the filter row is read 8 weights per 16-byte load (the row
// stride a multiple of 8), the row phase and row offset of a tap row are
// computed once per row, the column phase and offset once per tap.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBX = 32;
constexpr int kBY = 8;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__global__ void __launch_bounds__(kBX* kBY) raisr_apply_generic_l2_kernel(
    const float* __restrict__ planes, const int* __restrict__ buckets,
    const unsigned short* __restrict__ bank, float* __restrict__ out, int nb, int s, int fl,
    int hp, int rows, int wq, int h2p, int w2p, int nbucket, int row_stride) {
  const int ss = s * s;
  const int n = blockIdx.z / ss;
  const int t = blockIdx.z - n * ss;
  const int x = blockIdx.x * kBX + threadIdx.x;
  const int y = blockIdx.y * kBY + threadIdx.y;
  if (x >= w2p || y >= h2p) return;
  const int py = t / s;
  const int px = t - py * s;
  const int m = fl / 2;
  const int shift = (m / s + 1) * s;  // keeps / and % of tap offsets >= 0
  const size_t plane_px = static_cast<size_t>(h2p) * w2p;
  const size_t o = static_cast<size_t>(t) * plane_px + static_cast<size_t>(y) * w2p + x;
  const int bk = buckets[static_cast<size_t>(n % nb) * ss * plane_px + o];
  float acc = 0.0f;
  if (bk >= 0 && bk < nbucket) {
    const uint4* row = reinterpret_cast<const uint4*>(
        bank + (static_cast<size_t>(t) * nbucket + bk) * row_stride);
    const size_t plane = static_cast<size_t>(rows) * wq;
    const float* img = planes + static_cast<size_t>(n) * ss * plane + x + hp;
    const int ntap = fl * fl;
    const float* prow = nullptr;  // the tap row's planes, set when tj wraps to 0
    int ti = -1, tj = fl - 1;
    // 8 weights per 16-byte load of the row, the taps in order q = ti*fl + tj
    for (int q0 = 0; q0 < ntap; q0 += 8) {
      const uint4 chunk = __ldg(row + q0 / 8);
      const unsigned int words[4] = {chunk.x, chunk.y, chunk.z, chunk.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (q0 + j < ntap) {
          if (++tj == fl) {
            tj = 0;
            ++ti;
            const int vr = py - m + ti + shift;
            prow = img + static_cast<size_t>((vr % s) * s) * plane +
                   static_cast<size_t>(y + hp + vr / s - shift / s) * wq;
          }
          const int vc = px - m + tj + shift;
          const float tap = bf16_round(__ldg(prow + (vc % s) * plane + vc / s - shift / s));
          const unsigned int word = words[j / 2];
          const float wt = __uint_as_float(j % 2 ? word & 0xffff0000u : word << 16);
          acc = fmaf(tap, wt, acc);
        }
      }
    }
  }
  out[static_cast<size_t>(n) * ss * plane_px + o] = acc;
}

}  // namespace

// bank: per phase and bucket, fl*fl bf16 taps at a stride of row_stride
// (>= fl*fl, a multiple of 8) bf16, 16-byte aligned. Planes [nimg, s*s, rows, wq] with origin
// (hp, hp), hp >= ceil((fl / 2) / s), rows >= h2p + 2 hp, wq >= w2p + 2 hp;
// buckets [nb, s*s, h2p, w2p], nimg a multiple of nb. Any scale and filter
// length >= 1.
extern "C" int ocvk_raisr_apply_generic_l2(const float* planes, const int* buckets,
                                           const void* bank, float* out, int nimg, int nb,
                                           int s, int fl, int hp, int rows, int wq, int h2p,
                                           int w2p, int nbucket, int row_stride, void* stream) {
  if (s < 1 || fl < 1 || row_stride < fl * fl || row_stride % 8 != 0 ||
      (reinterpret_cast<uintptr_t>(bank) & 15u) != 0 || nb < 1 || nimg % nb != 0 ||
      hp * s < fl / 2 || static_cast<long long>(nimg) * s * s > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 block(kBX, kBY);
  const dim3 grid((w2p + kBX - 1) / kBX, (h2p + kBY - 1) / kBY, nimg * s * s);
  raisr_apply_generic_l2_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      planes, buckets, static_cast<const unsigned short*>(bank), out, nb, s, fl, hp, rows, wq,
      h2p, w2p, nbucket, row_stride);
  return static_cast<int>(cudaGetLastError());
}
