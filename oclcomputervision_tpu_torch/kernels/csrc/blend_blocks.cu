// Local-block histeq blend: per pixel, the bilinear blend of the 4 nearest
// block LUTs. x [B, H, W] uint8, m [B, nby, nbx, 256] float32 LUT grid ->
// out [B, H, W] uint8.
//
// Replaces two TPU kernels of oclcomputervision_tpu/ops/pallas/localeq_pallas.py:
// _blend_blocks (body _make_block_kernel; images the blocks divide) and
// _blend_tiles (body _make_kernel; mappings given by the caller, any
// geometry). Both split each float LUT into int8 integer and fraction parts
// for the MXU and relay pixels out as [8, 2048] strips; here the LUTs stay
// f32 and pixels stay where they are, so one kernel covers both.
//
// Semantics: the XLA twin ops/histeq.apply_block_mappings (hist.cl:104-147).
// The image is seen shifted down and right by half a block (padded row
// py = y + bh/2); padded tile (ty, tx) = (py / bh, px / bw), in-tile ramps
// t = (py % bh) / bh and s = (px % bw) / bw, corner LUTs from the
// edge-replicated grid P[k] = M[clip(k - 1, 0, n - 1)]:
//   out = (1-s)(1-t) P[ty][tx] + s(1-t) P[ty][tx+1] + (1-s)t P[ty+1][tx]
//         + st P[ty+1][tx+1],
// evaluated in that order with every product and sum rounded separately
// (the library builds with -fmad=false), clipped to [0, 255] and truncated:
// bit for bit the plain PyTorch version. The image must fit the padded grid:
// H <= (nby + 1) bh - bh/2 and W <= (nbx + 1) bw - bw/2.
//
// What bounds it on the H100: device memory, one read and one write of the
// image (at the bench geometry 64 x 768 x 1280: 126 MB, about 38 us at
// 3.35 TB/s); per pixel it does four shared-memory loads, two divisions and
// about ten flops.
// Design: grid (padded tile column, padded tile row x row split, image). The
// corner LUTs are constant on a padded tile, so a block loads its four (4 KB)
// into shared memory once, then blends rows_per_block rows of the tile, 16
// pixels per thread with 16-byte loads and stores when the tile's columns
// are 16-byte aligned, else one pixel per thread.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t blend(const float* lut, uint32_t v, float s, float t) {
  const float o = (1.0f - s) * (1.0f - t) * lut[v] + s * (1.0f - t) * lut[256 + v] +
                  (1.0f - s) * t * lut[512 + v] + s * t * lut[768 + v];
  return static_cast<uint32_t>(static_cast<int>(fminf(fmaxf(o, 0.0f), 255.0f)));
}

__global__ void __launch_bounds__(kThreads)
    blend_blocks_kernel(const uint8_t* __restrict__ x, const float* __restrict__ m,
                        uint8_t* __restrict__ out, int h, int w, int nby, int nbx,
                        int bh, int bw, int rows_per_block, int nsplit) {
  __shared__ float lut[4 * 256];
  const int tx = blockIdx.x;
  const int ty = blockIdx.y / nsplit;
  const int split = blockIdx.y - ty * nsplit;
  // image row / column of the padded tile's first row / column
  const int y_top = ty * bh - bh / 2;
  const int x_left = tx * bw - bw / 2;
  const int y0 = max(0, y_top + split * rows_per_block);
  const int y1 = min(h, y_top + min(bh, (split + 1) * rows_per_block));
  const int x0 = max(0, x_left);
  const int x1 = min(w, x_left + bw);
  if (y0 >= y1 || x0 >= x1) return;  // the whole block: no pixel here

  const int iy0 = min(max(ty - 1, 0), nby - 1);
  const int iy1 = min(ty, nby - 1);
  const int ix0 = min(max(tx - 1, 0), nbx - 1);
  const int ix1 = min(tx, nbx - 1);
  const float* mb = m + static_cast<size_t>(blockIdx.z) * nby * nbx * 256;
  for (int i = threadIdx.x; i < 4 * 256; i += kThreads) {
    const int c = i >> 8;
    const int iy = c < 2 ? iy0 : iy1;
    const int ix = (c & 1) ? ix1 : ix0;
    lut[i] = mb[(static_cast<size_t>(iy) * nbx + ix) * 256 + (i & 255)];
  }
  __syncthreads();

  const float fbh = static_cast<float>(bh);
  const float fbw = static_cast<float>(bw);
  const size_t img = static_cast<size_t>(blockIdx.z) * h * w;
  const int ncols = x1 - x0;
  const bool vec = w % 16 == 0 && x0 % 16 == 0 && ncols % 16 == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) & 15u) == 0;
  if (vec) {
    const int vpr = ncols / 16;
    const int total = (y1 - y0) * vpr;
    for (int i = threadIdx.x; i < total; i += kThreads) {
      const int r = i / vpr;
      const int y = y0 + r;
      const int xs = x0 + (i - r * vpr) * 16;
      const float t = static_cast<float>(y - y_top) / fbh;
      const size_t off = img + static_cast<size_t>(y) * w + xs;
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(x + off));
      const uint32_t in[4] = {q.x, q.y, q.z, q.w};
      uint32_t o[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        uint32_t acc = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float s = static_cast<float>(xs + 4 * k + j - x_left) / fbw;
          acc |= blend(lut, (in[k] >> (8 * j)) & 255u, s, t) << (8 * j);
        }
        o[k] = acc;
      }
      *reinterpret_cast<uint4*>(out + off) = make_uint4(o[0], o[1], o[2], o[3]);
    }
  } else {
    const int total = (y1 - y0) * ncols;
    for (int i = threadIdx.x; i < total; i += kThreads) {
      const int r = i / ncols;
      const int y = y0 + r;
      const int xx = x0 + (i - r * ncols);
      const float t = static_cast<float>(y - y_top) / fbh;
      const float s = static_cast<float>(xx - x_left) / fbw;
      const size_t off = img + static_cast<size_t>(y) * w + xx;
      out[off] = static_cast<uint8_t>(blend(lut, x[off], s, t));
    }
  }
}

}  // namespace

extern "C" int ocvk_blend_blocks(const uint8_t* x, const float* m, uint8_t* out, int nimg,
                                 int h, int w, int nby, int nbx, int bh, int bw,
                                 int rows_per_block, void* stream) {
  const int nsplit = (bh + rows_per_block - 1) / rows_per_block;
  const dim3 grid(nbx + 1, (nby + 1) * nsplit, nimg);
  blend_blocks_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, m, out, h, w, nby, nbx, bh, bw, rows_per_block, nsplit);
  return static_cast<int>(cudaGetLastError());
}
