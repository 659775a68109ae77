// Exact 256-bin histograms of uint8 rows: [B, N] -> [B, 256] int32.
//
// Replaces the TPU kernel oclcomputervision_tpu/ops/pallas/histeq_pallas.py,
// hist256_pallas (body _hist_kernel). The TPU has no scatter-add, so that
// kernel builds each histogram as a nibble one-hot matrix product on the MXU
// over [8, 2048] tiles, with zero padding whose count the caller subtracts
// from bin 0. None of that is carried over: a CUDA block counts with
// shared-memory atomics (hist_common.cuh), any N, no padding.
//
// What bounds it on the H100: device memory, one read of the image (at the
// bench geometry 256 x 768 x 1280: 251.7 MB, about 75 us at 3.35 TB/s), if
// the shared-memory atomics keep up (one per pixel, one per 16 pixels in a
// flat run).
// Design: grid (chunks, B). Each row splits into a scalar head up to the
// first 16-byte boundary, a body of 16-byte vectors and a scalar tail; a
// block reads kChunkVecs vectors of the body with 16-byte loads (the first
// block of a row also takes the head and the tail), counts them into its
// per-warp sub-histograms and adds the result to the row's output with
// global atomics. The entry point zeroes the output first.
#include "hist_common.cuh"

namespace {

using namespace ocvk_hist;

constexpr int kChunkVecs = 2048;  // 16-byte vectors per block: 32 KB of a row

__global__ void __launch_bounds__(kThreads)
    hist256_kernel(const uint8_t* __restrict__ x, int* __restrict__ out, int n) {
  __shared__ int sh[kWarps * 256];
  zero(sh);
  int* h = sh + (threadIdx.x >> 5) * 256;
  const uint8_t* row = x + static_cast<size_t>(blockIdx.y) * n;
  const int head = min(n, static_cast<int>((16u - (reinterpret_cast<uintptr_t>(row) & 15u)) & 15u));
  const int nvec = (n - head) / 16;
  const uint4* body = reinterpret_cast<const uint4*>(row + head);
  const int v_end = min(nvec, static_cast<int>(blockIdx.x + 1) * kChunkVecs);
  for (int i = blockIdx.x * kChunkVecs + threadIdx.x; i < v_end; i += kThreads) {
    count16(h, __ldg(body + i));
  }
  if (blockIdx.x == 0) {
    for (int i = threadIdx.x; i < head; i += kThreads) atomicAdd(h + row[i], 1);
    for (int i = head + nvec * 16 + threadIdx.x; i < n; i += kThreads) {
      atomicAdd(h + row[i], 1);
    }
  }
  flush(sh, out + static_cast<size_t>(blockIdx.y) * 256);
}

}  // namespace

extern "C" int ocvk_hist256(const uint8_t* x, int* out, int nimg, int n, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      cudaMemsetAsync(out, 0, sizeof(int) * 256 * static_cast<size_t>(nimg), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  // n / 16 bounds every row's body, whatever its head
  const dim3 grid(max(1, (n / 16 + kChunkVecs - 1) / kChunkVecs), nimg);
  hist256_kernel<<<grid, kThreads, 0, st>>>(x, out, n);
  return static_cast<int>(cudaGetLastError());
}
