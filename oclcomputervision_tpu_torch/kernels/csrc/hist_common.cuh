// Shared-memory histogram helpers of hist256.cu and hist_tiles.cu.
//
// A block of kThreads threads keeps one 256-bin int32 sub-histogram per warp
// in shared memory (8 x 1 KB), so the shared-memory atomics of different
// warps never meet on one address: a flat region, where most pixels fall in
// a few bins, serialises only inside a warp. At the end the block sums its
// sub-histograms and adds them to the output with one global atomic per
// non-empty bin. Counts are exact int32 in any order of the atomics.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ocvk_hist {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Zero the block's sub-histograms (kWarps x 256 int32).
__device__ __forceinline__ void zero(int* sh) {
  for (int i = threadIdx.x; i < kWarps * 256; i += kThreads) sh[i] = 0;
  __syncthreads();
}

__device__ __forceinline__ void count4(int* h, uint32_t w) {
  atomicAdd(h + (w & 255u), 1);
  atomicAdd(h + ((w >> 8) & 255u), 1);
  atomicAdd(h + ((w >> 16) & 255u), 1);
  atomicAdd(h + (w >> 24), 1);
}

// Count 16 pixels; a run of 16 equal bytes (a flat region) is one atomic.
__device__ __forceinline__ void count16(int* h, uint4 q) {
  const uint32_t rep = (q.x & 255u) * 0x01010101u;
  if (q.x == rep && q.y == rep && q.z == rep && q.w == rep) {
    atomicAdd(h + (q.x & 255u), 16);
    return;
  }
  count4(h, q.x);
  count4(h, q.y);
  count4(h, q.z);
  count4(h, q.w);
}

// Sum the sub-histograms and add the block's counts to out[0..255].
__device__ __forceinline__ void flush(const int* sh, int* out) {
  __syncthreads();
  for (int b = threadIdx.x; b < 256; b += kThreads) {
    int s = 0;
    for (int w = 0; w < kWarps; ++w) s += sh[w * 256 + b];
    if (s != 0) atomicAdd(out + b, s);
  }
}

}  // namespace ocvk_hist
