// Local-block histeq blend: per pixel, the bilinear blend of the 4 nearest
// block LUTs. x [B, H, W] uint8, m [B, nby, nbx, 256] float32 LUT grid ->
// out [B, H, W] uint8. Row 0 of x is image row row0 of the grid's image: a
// row band of it (the row-sharded local histeq, ops/histeq.py's
// apply_block_mappings_band), or the whole image at row0 = 0.
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
// py = row0 + y + bh/2); padded tile (ty, tx) = (py / bh, px / bw), in-tile ramps
// t = (py % bh) / bh and s = (px % bw) / bw, corner LUTs from the
// edge-replicated grid P[k] = M[clip(k - 1, 0, n - 1)]:
//   out = (1-s)(1-t) P[ty][tx] + s(1-t) P[ty][tx+1] + (1-s)t P[ty+1][tx]
//         + st P[ty+1][tx+1],
// evaluated in that order with every product and sum rounded separately
// (the library builds with -fmad=false), clipped to [0, 255] and truncated:
// bit for bit the plain PyTorch version (kernels/localeq.blend_blocks). The
// band must fit the padded grid: -bh/2 <= row0, row0 + H <= (nby + 1) bh -
// bh/2 and W <= (nbx + 1) bw - bw/2. The grid's rows are the padded tile
// rows the band touches, from tile ty_first.
//
// What bounds it on the H100: device memory, one read and one write of the
// image (at the bench geometry 64 x 768 x 1280: 126 MB, about 38 us at
// 3.35 TB/s), once the table lookups cost little. The first form kept
// the four corner LUTs apart (4 KB) and read them with four 4-byte gathers
// per pixel: the 32 lanes of a warp hit random levels, about 3.5 shared-
// memory passes per gather and 14 per 32 pixels, near 0.11 ms at the bench
// geometry; it also divided once per pixel for the column ramp.
// Design:
//  - The four corner LUTs are interleaved as one float4 per level and the
//    table is replicated 8 times, copy j at float4 index 8 v + j (32 KB). A
//    16-byte load is served a quarter-warp at a time; lane l reads copy
//    l % 8, so the 8 lanes of a quarter land on 8 distinct 16-byte bank
//    groups whatever their levels: one pass per quarter, 4 per 32 pixels.
//  - A block takes rows_per_block rows of one padded tile (the corner LUTs
//    are constant there), so the 32 KB staging is paid per 32 K pixels.
//  - A thread keeps the same 16 columns (one 16-byte load and store per row
//    when the tile's columns are 16-byte aligned) across its rows: s and
//    1 - s are divided once per column, t and 1 - t once per row; a pixel
//    costs one table load, four weight products, four products, three sums,
//    a saturating conversion and one integer min for the clip; each row's
//    pixels are loaded a row ahead. Otherwise one pixel per thread, the same
//    table and arithmetic.
// Measured at the bench geometry (NVIDIA H100 80GB HBM3, 700 W power limit;
// kernels/forms.py): 0.0689 ms; the first form 0.1198, and without its four
// gathers 0.0916 (so the gathers cost about a quarter of it). With the table
// staged 8 loads deep this form took 0.0742, without its table load 0.0570
// and without the float-to-int conversion 0.0730: after the table, the
// memory stream itself runs at about 2.2 of the card's 3.35 TB/s. Without
// the register bound 0.0708; 8 pixels a thread 0.0742 (0.0722 at six
// blocks per SM), 4 pixels 0.0891 (PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCopies = 8;  // table copies: the lanes of a quarter-warp
constexpr int kVec = 16;    // pixels per thread and row in the aligned path

// kVec pixels, moved with one vector load or store
struct alignas(kVec) Pixels {
  uint32_t word[kVec / 4];
};

// clip to [0, 255] and truncate: the conversion to unsigned saturates
// (negative and NaN to 0), so one integer min finishes the clip
__device__ __forceinline__ uint32_t blend(const float4 c, float oms, float s, float omt,
                                          float t) {
  const float o = oms * omt * c.x + s * omt * c.y + oms * t * c.z + s * t * c.w;
  return min(__float2uint_rz(o), 255u);
}

// five blocks per SM: at most 51 registers a thread (80 unbounded: three
// blocks)
__global__ void __launch_bounds__(kThreads, 5)
    blend_blocks_kernel(const uint8_t* __restrict__ x, const float* __restrict__ m,
                        uint8_t* __restrict__ out, int h, int w, int row0, int nby,
                        int nbx, int bh, int bw, int rows_per_block, int nsplit,
                        int ty_first) {
  __shared__ float4 tab[256 * kCopies];
  const int tx = blockIdx.x;
  const int tyl = blockIdx.y / nsplit;
  const int ty = ty_first + tyl;
  const int split = blockIdx.y - tyl * nsplit;
  // band row / image column of the padded tile's first row / column
  const int y_top = ty * bh - bh / 2 - row0;
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
  const float* l00 = mb + (static_cast<size_t>(iy0) * nbx + ix0) * 256;
  const float* l01 = mb + (static_cast<size_t>(iy0) * nbx + ix1) * 256;
  const float* l10 = mb + (static_cast<size_t>(iy1) * nbx + ix0) * 256;
  const float* l11 = mb + (static_cast<size_t>(iy1) * nbx + ix1) * 256;
  // thread v loads level v of the four LUTs (four coalesced loads, one
  // latency) and writes its 8 copies, copy (j + v) % 8 at step j: the 8
  // lanes of a quarter-warp write 8 distinct bank groups at every step
  static_assert(kThreads == 256, "one thread per level");
  {
    const int v = threadIdx.x;
    const float4 c = make_float4(__ldg(l00 + v), __ldg(l01 + v), __ldg(l10 + v), __ldg(l11 + v));
#pragma unroll
    for (int j = 0; j < kCopies; ++j) tab[v * kCopies + ((j + v) & (kCopies - 1))] = c;
  }
  __syncthreads();
  const float4* mine = tab + (threadIdx.x & (kCopies - 1));  // this lane's copy

  const float fbh = static_cast<float>(bh);
  const float fbw = static_cast<float>(bw);
  const size_t img = static_cast<size_t>(blockIdx.z) * h * w;
  const int ncols = x1 - x0;
  const bool vec = w % kVec == 0 && x0 % kVec == 0 && ncols % kVec == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) &
                    (kVec - 1)) == 0;
  if (vec) {
    const int vpr = ncols / kVec;  // kVec-column groups of the tile
    const int col_threads = min(vpr, kThreads);
    const int row_threads = kThreads / col_threads;
    const int rt = threadIdx.x / col_threads;
    if (rt >= row_threads) return;
    for (int g = threadIdx.x - rt * col_threads; g < vpr; g += col_threads) {
      const int xs = x0 + g * kVec;
      float s[kVec], oms[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        s[j] = static_cast<float>(xs + j - x_left) / fbw;
        oms[j] = 1.0f - s[j];
      }
      // each row's kVec pixels are loaded one row ahead, so the load's
      // latency hides behind a row of arithmetic
      const uint8_t* src = x + img + xs;
      Pixels next = y0 + rt < y1 ? *reinterpret_cast<const Pixels*>(
                                       src + static_cast<size_t>(y0 + rt) * w)
                                 : Pixels{};
      for (int y = y0 + rt; y < y1; y += row_threads) {
        const float t = static_cast<float>(y - y_top) / fbh;
        const float omt = 1.0f - t;
        const Pixels q = next;
        if (y + row_threads < y1)
          next = *reinterpret_cast<const Pixels*>(src + static_cast<size_t>(y + row_threads) * w);
        Pixels o;
#pragma unroll
        for (int k = 0; k < kVec / 4; ++k) {
          uint32_t acc = 0;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t v = (q.word[k] >> (8 * j)) & 255u;
            const int c = 4 * k + j;
            acc |= blend(mine[v * kCopies], oms[c], s[c], omt, t) << (8 * j);
          }
          o.word[k] = acc;
        }
        *reinterpret_cast<Pixels*>(out + img + static_cast<size_t>(y) * w + xs) = o;
      }
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
      out[off] = static_cast<uint8_t>(blend(mine[x[off] * kCopies], 1.0f - s, s, 1.0f - t, t));
    }
  }
}

}  // namespace

extern "C" int ocvk_blend_blocks(const uint8_t* x, const float* m, uint8_t* out, int nimg,
                                 int h, int w, int row0, int nby, int nbx, int bh, int bw,
                                 int rows_per_block, void* stream) {
  const int nsplit = (bh + rows_per_block - 1) / rows_per_block;
  // the padded tile rows of the band's first and last rows (row0 >= -bh/2,
  // so the padded rows are >= 0): kernels/localeq.blend_tile_rows
  const int ty_first = (row0 + bh / 2) / bh;
  const int ty_last = (row0 + h - 1 + bh / 2) / bh;
  const dim3 grid(nbx + 1, (ty_last - ty_first + 1) * nsplit, nimg);
  blend_blocks_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, m, out, h, w, row0, nby, nbx, bh, bw, rows_per_block, nsplit, ty_first);
  return static_cast<int>(cudaGetLastError());
}
