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
// Semantics: median3x3 of _fast_rounds (oclcomputervision_tpu/ops/motion.py):
// Paeth's 19-exchange network on the nine values; the median of nine
// integers is unique, so any exact selection gives the same plane.
//
// What bounds it on the H100: device memory, 8 bytes read and 8 written per
// pixel (5 MB at one VGA pair); the nine reads per plane come from the cache.
// Design: one thread per pixel and both planes, 32 x 8 pixels per block.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

__device__ __forceinline__ void exchange(int& a, int& b) {
  const int lo = min(a, b);
  b = max(a, b);
  a = lo;
}

__device__ __forceinline__ int median9(int* v) {
  // Paeth's network (MEDIAN9_EXCHANGES of oracle/motion.py)
  exchange(v[1], v[2]); exchange(v[4], v[5]); exchange(v[7], v[8]);
  exchange(v[0], v[1]); exchange(v[3], v[4]); exchange(v[6], v[7]);
  exchange(v[1], v[2]); exchange(v[4], v[5]); exchange(v[7], v[8]);
  exchange(v[0], v[3]); exchange(v[5], v[8]); exchange(v[4], v[7]);
  exchange(v[3], v[6]); exchange(v[1], v[4]); exchange(v[2], v[5]);
  exchange(v[4], v[7]); exchange(v[4], v[2]); exchange(v[6], v[4]);
  exchange(v[4], v[2]);
  return v[4];
}

__device__ __forceinline__ int median_at(const int* __restrict__ plane, int y, int x, int h, int w) {
  int v[9];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int yy = min(max(y + j - 1, 0), h - 1);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int xx = min(max(x + i - 1, 0), w - 1);
      v[j * 3 + i] = __ldg(plane + static_cast<size_t>(yy) * w + xx);
    }
  }
  return median9(v);
}

__global__ void __launch_bounds__(kBlockX* kBlockY)
    me_fast_median_kernel(const int* __restrict__ dy_in, const int* __restrict__ dx_in,
                          int* __restrict__ dy_out, int* __restrict__ dx_out,
                          float* __restrict__ flow, int h, int w) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= w || y >= h) return;
  const size_t img = static_cast<size_t>(blockIdx.z) * h * w;
  const int my = median_at(dy_in + img, y, x, h, w);
  const int mx = median_at(dx_in + img, y, x, h, w);
  const size_t p = img + static_cast<size_t>(y) * w + x;
  if (flow != nullptr) {
    flow[2 * p] = static_cast<float>(mx);
    flow[2 * p + 1] = static_cast<float>(my);
  } else {
    dy_out[p] = my;
    dx_out[p] = mx;
  }
}

}  // namespace

// flow non-null: write the float32 flow and leave dy_out, dx_out (which may
// then be null) alone.
extern "C" int ocvk_me_fast_median(const int* dy_in, const int* dx_in, int* dy_out, int* dx_out,
                                   float* flow, int nimg, int h, int w, void* stream) {
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((w + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY, nimg);
  me_fast_median_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      dy_in, dx_in, dy_out, dx_out, flow, h, w);
  return static_cast<int>(cudaGetLastError());
}
