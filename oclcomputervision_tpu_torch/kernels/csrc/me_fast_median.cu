// The 3x3 median that closes each round of the fast block matching: per
// pixel, the median of the nine neighbours of each state plane, with edge
// replication at the image borders. dy, dx [B, H, W] int32 -> the filtered
// planes, or, for the last round, the flow [B, H, W, 2] float32 (u = dx,
// v = dy).
//
// Replaces, together with me_fast_round.cu, the TPU kernel
// me_fast_residual_pallas (oclcomputervision_tpu/ops/pallas/me_fast_pallas.py,
// body _make_fast_kernel, its median3x3), which filters the state of a whole
// row band in VMEM between rounds. Blocks of a CUDA grid cannot wait for
// their neighbours' new state inside one launch, so the median is a launch
// of its own between two rounds.
//
// Semantics: median3x3 of _fast_rounds (oclcomputervision_tpu/ops/motion.py).
// The median of nine integers is unique, so any exact selection gives the
// same plane as the plain version's 19-exchange network (Paeth's).
//
// What bounds it on the H100: device memory, 8 bytes read and 8 written per
// pixel (5 MB at one VGA pair), read from L2 on the path, where the round
// has just written them.
// Design: a thread computes 4 horizontally adjacent pixels in 2 rows of
// both planes. Per plane it reads the 4 rows y-1 .. y+2 as one 16-byte load
// each of its own columns and two 4-byte loads of the columns beside them
// (rows and columns clamped at the edges; the neighbours' 16-byte loads
// bring those into L1), sorts each column of 3 once per output row (the
// pair of rows y, y+1 is sorted once for both: 10 min/max per column), and
// takes each median as med3(max of the column minima, med3 of the column
// medians, min of the column maxima), the median of nine exactly: 12
// min/max per pixel, 20 in all against the network's 38. It writes 16
// bytes at a time: an int4 per state row, two float4 of (u, v) pairs per
// flow row. Rows whose width is not a multiple of 4 (or unaligned planes)
// take 4-byte loads and stores with the tail masked.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockX = 32;  // threads across: 128 columns
constexpr int kBlockY = 8;   // threads down: 16 rows
constexpr int kCols = 4;     // adjacent columns per thread
constexpr int kRows = 2;     // rows per thread

__device__ __forceinline__ int med3(int a, int b, int c) { return max(min(a, b), min(max(a, b), c)); }

// Medians of rows y and y + 1 at columns x .. x + 3 of one plane: v holds
// rows y - 1 .. y + 2 at columns x - 1 .. x + 4, clamped.
__device__ __forceinline__ void median_2x4(const int (&v)[4][kCols + 2], int (&m)[kRows][kCols]) {
  int lo[kRows][kCols + 2], mid[kRows][kCols + 2], hi[kRows][kCols + 2];
#pragma unroll
  for (int j = 0; j < kCols + 2; ++j) {
    const int a = min(v[1][j], v[2][j]);  // the pair both output rows share
    const int b = max(v[1][j], v[2][j]);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int c = v[i ? 3 : 0][j];
      lo[i][j] = min(a, c);
      mid[i][j] = max(a, min(b, c));
      hi[i][j] = max(b, c);
    }
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int k = 0; k < kCols; ++k)
      m[i][k] = med3(max(max(lo[i][k], lo[i][k + 1]), lo[i][k + 2]),
                     med3(mid[i][k], mid[i][k + 1], mid[i][k + 2]),
                     min(min(hi[i][k], hi[i][k + 1]), hi[i][k + 2]));
}

// Rows y - 1 .. y + 2 (clamped) at columns x - 1 .. x + 4 (clamped) of a plane.
template <bool kVec>
__device__ __forceinline__ void load_window(const int* __restrict__ plane, int y, int x, int h,
                                            int w, int (&v)[4][kCols + 2]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int* row = plane + static_cast<size_t>(min(max(y + r - 1, 0), h - 1)) * w;
    if (kVec) {
      const int4 c = __ldg(reinterpret_cast<const int4*>(row + x));
      v[r][0] = __ldg(row + max(x - 1, 0));
      v[r][1] = c.x;
      v[r][2] = c.y;
      v[r][3] = c.z;
      v[r][4] = c.w;
      v[r][5] = __ldg(row + min(x + kCols, w - 1));
    } else {
#pragma unroll
      for (int j = 0; j < kCols + 2; ++j) v[r][j] = __ldg(row + min(max(x + j - 1, 0), w - 1));
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kBlockX* kBlockY)
    me_fast_median_kernel(const int* __restrict__ dy_in, const int* __restrict__ dx_in,
                          int* __restrict__ dy_out, int* __restrict__ dx_out,
                          float* __restrict__ flow, int h, int w) {
  const int x = (blockIdx.x * kBlockX + threadIdx.x) * kCols;
  const int y = (blockIdx.y * kBlockY + threadIdx.y) * kRows;
  if (x >= w || y >= h) return;
  const size_t img = static_cast<size_t>(blockIdx.z) * h * w;
  int v[4][kCols + 2];
  int my[kRows][kCols], mx[kRows][kCols];
  load_window<kVec>(dy_in + img, y, x, h, w, v);
  median_2x4(v, my);
  load_window<kVec>(dx_in + img, y, x, h, w, v);
  median_2x4(v, mx);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    if (y + i >= h) break;
    const size_t p = img + static_cast<size_t>(y + i) * w + x;
    if (kVec) {
      if (flow != nullptr) {
        float4* f = reinterpret_cast<float4*>(flow + 2 * p);
        f[0] = make_float4(static_cast<float>(mx[i][0]), static_cast<float>(my[i][0]),
                           static_cast<float>(mx[i][1]), static_cast<float>(my[i][1]));
        f[1] = make_float4(static_cast<float>(mx[i][2]), static_cast<float>(my[i][2]),
                           static_cast<float>(mx[i][3]), static_cast<float>(my[i][3]));
      } else {
        *reinterpret_cast<int4*>(dy_out + p) = make_int4(my[i][0], my[i][1], my[i][2], my[i][3]);
        *reinterpret_cast<int4*>(dx_out + p) = make_int4(mx[i][0], mx[i][1], mx[i][2], mx[i][3]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        if (x + k >= w) break;
        if (flow != nullptr) {
          flow[2 * (p + k)] = static_cast<float>(mx[i][k]);
          flow[2 * (p + k) + 1] = static_cast<float>(my[i][k]);
        } else {
          dy_out[p + k] = my[i][k];
          dx_out[p + k] = mx[i][k];
        }
      }
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// flow non-null: write the float32 flow and leave dy_out, dx_out (which may
// then be null) alone.
extern "C" int ocvk_me_fast_median(const int* dy_in, const int* dx_in, int* dy_out, int* dx_out,
                                   float* flow, int nimg, int h, int w, void* stream) {
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((w + kBlockX * kCols - 1) / (kBlockX * kCols),
                  (h + kBlockY * kRows - 1) / (kBlockY * kRows), nimg);
  const bool vec = w % kCols == 0 && aligned16(dy_in) && aligned16(dx_in) &&
                   (flow != nullptr ? aligned16(flow) : aligned16(dy_out) && aligned16(dx_out));
  const auto kernel = vec ? me_fast_median_kernel<true> : me_fast_median_kernel<false>;
  kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(dy_in, dx_in, dy_out, dx_out,
                                                               flow, h, w);
  return static_cast<int>(cudaGetLastError());
}
