// Row-wise 256-entry LUT apply: x [B, N] uint8, luts [B, 256] uint8 ->
// out [B, N] uint8, out[b, p] = luts[b, x[b, p]].
//
// Replaces the TPU kernel oclcomputervision_tpu/ops/pallas/histeq_pallas.py,
// apply_lut_pallas (body _apply_kernel), which turns the gather into a
// block-diagonal nibble one-hot matrix product on the MXU because the TPU
// has no fast per-pixel gather. On the H100 the LUT sits in shared memory
// and each pixel is one shared-memory byte load.
//
// What bounds it on the H100: device memory, one read and one write of the
// image (at the bench geometry 256 x 768 x 1280: 503 MB, about 150 us at
// 3.35 TB/s).
// Design: grid (chunks, B). A block copies its row's LUT to shared memory,
// then maps kChunkVecs 16-byte vectors of the row with 16-byte loads and
// stores; the first block of a row also maps the scalar head (up to the
// first 16-byte boundary) and tail. If input and output rows sit at
// different offsets from a 16-byte boundary, the blocks map single bytes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunkVecs = 2048;  // 16-byte vectors per block: 32 KB of a row

__device__ __forceinline__ uint32_t map4(const uint8_t* lut, uint32_t w) {
  return static_cast<uint32_t>(lut[w & 255u]) |
         (static_cast<uint32_t>(lut[(w >> 8) & 255u]) << 8) |
         (static_cast<uint32_t>(lut[(w >> 16) & 255u]) << 16) |
         (static_cast<uint32_t>(lut[w >> 24]) << 24);
}

__global__ void __launch_bounds__(kThreads)
    apply_lut_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ luts,
                     uint8_t* __restrict__ out, int n) {
  __shared__ uint8_t lut[256];
  for (int i = threadIdx.x; i < 256; i += kThreads) {
    lut[i] = luts[static_cast<size_t>(blockIdx.y) * 256 + i];
  }
  __syncthreads();
  const uint8_t* xr = x + static_cast<size_t>(blockIdx.y) * n;
  uint8_t* orow = out + static_cast<size_t>(blockIdx.y) * n;
  const bool vec =
      ((reinterpret_cast<uintptr_t>(xr) - reinterpret_cast<uintptr_t>(orow)) & 15u) == 0;
  if (!vec) {
    const int end = min(n, static_cast<int>(blockIdx.x + 1) * kChunkVecs * 16);
    for (int i = blockIdx.x * kChunkVecs * 16 + threadIdx.x; i < end; i += kThreads) {
      orow[i] = lut[xr[i]];
    }
    return;
  }
  const int head = min(n, static_cast<int>((16u - (reinterpret_cast<uintptr_t>(xr) & 15u)) & 15u));
  const int nvec = (n - head) / 16;
  const uint4* src = reinterpret_cast<const uint4*>(xr + head);
  uint4* dst = reinterpret_cast<uint4*>(orow + head);
  const int v_end = min(nvec, static_cast<int>(blockIdx.x + 1) * kChunkVecs);
  for (int i = blockIdx.x * kChunkVecs + threadIdx.x; i < v_end; i += kThreads) {
    const uint4 q = __ldg(src + i);
    dst[i] = make_uint4(map4(lut, q.x), map4(lut, q.y), map4(lut, q.z), map4(lut, q.w));
  }
  if (blockIdx.x == 0) {
    for (int i = threadIdx.x; i < head; i += kThreads) orow[i] = lut[xr[i]];
    for (int i = head + nvec * 16 + threadIdx.x; i < n; i += kThreads) orow[i] = lut[xr[i]];
  }
}

}  // namespace

extern "C" int ocvk_apply_lut(const uint8_t* x, const uint8_t* luts, uint8_t* out,
                              int nimg, int n, void* stream) {
  // n / 16 vectors (or n bytes in chunks of 16 * kChunkVecs) bound every row
  const dim3 grid(max(1, (n + 16 * kChunkVecs - 1) / (16 * kChunkVecs)), nimg);
  apply_lut_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(x, luts, out, n);
  return static_cast<int>(cudaGetLastError());
}
