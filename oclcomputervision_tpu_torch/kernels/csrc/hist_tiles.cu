// Exact per-tile 256-bin histograms straight off the image:
// [B, H, W] uint8 -> [B, H/th, W/tw, 256] int32, for any tile (th, tw) that
// divides the image.
//
// Replaces the TPU kernel oclcomputervision_tpu/ops/pallas/localeq_pallas.py,
// hist_tiles_pallas (body _hist_tile_kernel_factory), which histograms the
// (bh/2, bw/2) quadrant tiles through the nibble one-hot MXU product after
// relaying each block out as [8, 2048] strips (a Mosaic layout). Here the
// local-histeq op asks for the block tiles themselves, and a CUDA block
// counts with shared-memory atomics (hist_common.cuh).
//
// What bounds it on the H100: device memory, one read of the image (at the
// bench geometry 64 x 768 x 1280: 62.9 MB, about 19 us at 3.35 TB/s), if the
// shared-memory atomics keep up.
// Design: grid (tile column, tile row x row split, image). A block counts
// rows_per_block rows of one tile into its per-warp sub-histograms and adds
// them to the tile's output with global atomics; the entry point zeroes the
// output first. When rows and tiles are 16-byte aligned it reads 16-byte
// vectors, else single bytes.
#include "hist_common.cuh"

namespace {

using namespace ocvk_hist;

__global__ void __launch_bounds__(kThreads)
    hist_tiles_kernel(const uint8_t* __restrict__ x, int* __restrict__ out, int h,
                      int w, int th, int tw, int rows_per_block, int nsplit) {
  __shared__ int sh[kWarps * 256];
  const int tx = blockIdx.x;
  const int ty = blockIdx.y / nsplit;
  const int r0 = (blockIdx.y - ty * nsplit) * rows_per_block;
  const int nrows = min(rows_per_block, th - r0);
  zero(sh);
  int* hw = sh + (threadIdx.x >> 5) * 256;
  const uint8_t* tile =
      x + (static_cast<size_t>(blockIdx.z) * h + ty * th + r0) * w + static_cast<size_t>(tx) * tw;
  const bool vec = w % 16 == 0 && tw % 16 == 0 && (reinterpret_cast<uintptr_t>(x) & 15u) == 0;
  if (vec) {
    const int vpr = tw / 16;
    const int total = nrows * vpr;
    for (int i = threadIdx.x; i < total; i += kThreads) {
      const int r = i / vpr;
      const int c = i - r * vpr;
      count16(hw, __ldg(reinterpret_cast<const uint4*>(tile + static_cast<size_t>(r) * w) + c));
    }
  } else {
    const int total = nrows * tw;
    for (int i = threadIdx.x; i < total; i += kThreads) {
      const int r = i / tw;
      const int c = i - r * tw;
      atomicAdd(hw + tile[static_cast<size_t>(r) * w + c], 1);
    }
  }
  const int nty = h / th;
  flush(sh, out + ((static_cast<size_t>(blockIdx.z) * nty + ty) * gridDim.x + tx) * 256);
}

}  // namespace

extern "C" int ocvk_hist_tiles(const uint8_t* x, int* out, int nimg, int h, int w,
                               int th, int tw, int rows_per_block, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nty = h / th;
  const int ntx = w / tw;
  const cudaError_t err = cudaMemsetAsync(
      out, 0, sizeof(int) * 256 * static_cast<size_t>(nimg) * nty * ntx, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nsplit = (th + rows_per_block - 1) / rows_per_block;
  const dim3 grid(ntx, nty * nsplit, nimg);
  hist_tiles_kernel<<<grid, kThreads, 0, st>>>(x, out, h, w, th, tw, rows_per_block, nsplit);
  return static_cast<int>(cudaGetLastError());
}
