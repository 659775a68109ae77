// The k x k median filter of a flow field: per pixel and per plane, the
// median of the k x k window around it, edges replicated (rows and columns
// clamped). flow [B, H, W, 2] float32, (u, v) interleaved -> a new flow of
// the same shape.
//
// Replaces no TPU kernel: the JAX package's median_filter_flow
// (oclcomputervision_tpu/ops/motion.py) is plain jnp, a pruned Batcher
// comparator network (_median_network) over k^2 shifted copies. Its PyTorch
// port ran F.pad, F.unfold and Tensor.median over two planes at a time
// (kernels/motion.flow_median, kept as the plain version for CPU tensors):
// the unfolded window holds k^2 copies of each plane (796 MB per 9 x 9
// median of 4 VGA flows), and aten's data-dependent selection slows down on
// the tie-heavy flows the subpixel rounds leave. That was 82 % of the hybrid
// pyramid's call.
//
// Semantics: the median of an odd number of finite values is one value, so
// any exact selection equals the plain version's. The kernels compare int
// keys with the floats' order (to_key: -0.0 just below +0.0), so a window
// whose median is a zero may return the other zero: equal under ==.
//
// What bounds it on the H100: min/max issue. The bytes are tiny (8 read and
// 8 written per pixel: 19.7 MB, 5.9 us at 3.35 TB/s, at one 9 x 9 median of
// 4 VGA flows); selecting the 41st of 81 values takes 1324 min/max per
// output and plane with the JAX package's network.
// Design (flow_median_kernel<K>, K = 3, 5, 7, 9): a block of 32 x 4 threads
// stages its 8 x 64 outputs' window, (8 + K - 1) x (64 + K - 1) pixels of
// both planes, as keys in shared memory, once (a float a thread in the
// flow's own order: coalesced, and no alignment asked of the flow; rows and
// columns clamped). A thread computes 2 x 2 outputs of
// each plane from the (K + 1) x (K + 1) union of their windows (8-byte
// shared loads). The four windows share their (K - 1) x (K - 1) core; each
// adds its own row of K and column of K - 1, 2K - 1 values. The core is
// sorted once by Batcher's odd-even mergesort (padded to a power of two with
// +inf keys); the median of a window lies within ranks [m - (2K - 1), m] of
// the sorted core (m = K^2 / 2), whatever its own values, and is the
// (2K - 1)-th smallest of that band and its own values, sorted by the same
// network: min over i of max(band[i - 1], own[2K - 1 - i]) and band[2K - 1].
// Ranks outside the core are -inf / +inf constants. The networks are
// template recursions over compile-time wire numbers, so each is straight-
// line code on registers, and the compiler folds the pads and drops every
// min or max whose result no output reads: 431 min/max per output and plane
// at K = 9 (kernels/motion.flow_median_minmax), a third of the network's.
// No branch depends on the data, so tie-heavy flows cost what random ones do.
//
// flow_median_generic_kernel, for any other odd k: a thread a pixel, both
// planes; the median key is built bit by bit from the top (32 passes over
// the window, read through the read-only cache with rows and columns
// clamped): a bit is kept where at most m window keys lie below the trial
// key. Exact for any k, with no shared memory to outgrow.
#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>

namespace {

constexpr int kThreadsX = 32;            // threads across a block
constexpr int kThreadsY = 4;             // threads down
constexpr int kTileW = 2 * kThreadsX;    // 64 output columns a block: 2 a thread
constexpr int kTileH = 2 * kThreadsY;    // 8 output rows a block: 2 a thread
constexpr int kGenericX = 32, kGenericY = 8;

// float -> int key in the floats' order (-0.0 just below +0.0); its own inverse
__device__ __forceinline__ int to_key(float f) {
  const int b = __float_as_int(f);
  return b ^ ((b >> 31) & INT_MAX);
}
__device__ __forceinline__ float from_key(int k) { return __int_as_float(k ^ ((k >> 31) & INT_MAX)); }

// float -> unsigned key in the floats' order, and back
__device__ __forceinline__ unsigned to_ukey(float f) {
  const int b = __float_as_int(f);
  return static_cast<unsigned>(b ^ ((b >> 31) | INT_MIN));
}
__device__ __forceinline__ float from_ukey(unsigned u) {
  return __int_as_float(static_cast<int>(u ^ ((static_cast<int>(~u) >> 31) | INT_MIN)));
}

__device__ __forceinline__ void cswap(int& a, int& b) {
  const int lo = min(a, b);
  b = max(a, b);
  a = lo;
}

__host__ __device__ constexpr int pow2_at_least(int n) { return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2); }

// Batcher's odd-even merge of wires [LO, HI] (inclusive, a power of two
// long) whose halves are sorted, comparing wires R apart.
template <int LO, int HI, int R>
__device__ __forceinline__ void oe_merge(int* v) {
  if constexpr (2 * R < HI - LO) {
    oe_merge<LO, HI, 2 * R>(v);
    oe_merge<LO + R, HI, 2 * R>(v);
#pragma unroll
    for (int i = LO + R; i < HI - R; i += 2 * R) cswap(v[i], v[i + R]);
  } else {
    cswap(v[LO], v[LO + R]);
  }
}

// Batcher's odd-even mergesort of wires [LO, HI] (inclusive).
template <int LO, int HI>
__device__ __forceinline__ void oe_sort(int* v) {
  if constexpr (HI > LO) {
    constexpr int kMid = LO + (HI - LO) / 2;
    oe_sort<LO, kMid>(v);
    oe_sort<kMid + 1, HI>(v);
    oe_merge<LO, HI, 1>(v);
  }
}

template <int K>
struct Plan {
  static constexpr int kRows = kTileH + K - 1;         // staged rows of a block
  static constexpr int kCols = kTileW + K - 1;         // staged columns (even: 8-byte reads)
  static constexpr int kCore = (K - 1) * (K - 1);      // the window part 2 x 2 outputs share
  static constexpr int kOwn = 2 * K - 1;               // each output's own values
  static constexpr int kMid = K * K / 2;               // the median's rank in a window
  static constexpr int kBand = kMid - kOwn;            // the core's lowest rank that can be it
  static constexpr int kBandLo = kBand < 0 ? 0 : kBand;              // the band's ranks that
  static constexpr int kBandHi = kMid < kCore ? kMid : kCore - 1;    // lie inside the core
  static constexpr int kCoreWires = pow2_at_least(kCore);
  static constexpr int kOwnWires = pow2_at_least(kOwn);
};

// The medians of one plane at the thread's 2 x 2 outputs (w: the union of
// their windows, rows and columns 0 .. K), written to plane p of the flow.
template <int K>
__device__ __forceinline__ void median_2x2(const int (&w)[K + 1][K + 1], float* __restrict__ out,
                                           size_t img, int y, int x, int h, int width, int p) {
  using P = Plan<K>;
  int core[P::kCoreWires];
#pragma unroll
  for (int i = 0; i < P::kCore; ++i) core[i] = w[1 + i / (K - 1)][1 + i % (K - 1)];
#pragma unroll
  for (int i = P::kCore; i < P::kCoreWires; ++i) core[i] = INT_MAX;
  oe_sort<0, P::kCoreWires - 1>(core);
  // the core's ranks kBand .. kMid; -inf below rank 0, +inf above the core
  int band[P::kOwn + 1];
#pragma unroll
  for (int i = 0; i <= P::kOwn; ++i) band[i] = i < -P::kBand ? INT_MIN : INT_MAX;
#pragma unroll
  for (int r = P::kBandLo; r <= P::kBandHi; ++r) band[r - P::kBand] = core[r];
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      // the output's own row (K columns from dx) and column (the core's rows)
      int own[P::kOwnWires];
#pragma unroll
      for (int j = 0; j < K; ++j) own[j] = w[dy ? K : 0][dx + j];
#pragma unroll
      for (int j = K; j < P::kOwn; ++j) own[j] = w[j - K + 1][dx ? K : 0];
#pragma unroll
      for (int j = P::kOwn; j < P::kOwnWires; ++j) own[j] = INT_MAX;
      oe_sort<0, P::kOwnWires - 1>(own);
      int m = band[P::kOwn];
#pragma unroll
      for (int i = 1; i <= P::kOwn; ++i) m = min(m, max(band[i - 1], own[P::kOwn - i]));
      if (y + dy < h && x + dx < width)
        out[2 * (img + static_cast<size_t>(y + dy) * width + x + dx) + p] = from_key(m);
    }
  }
}

template <int K>
__global__ void __launch_bounds__(kThreadsX* kThreadsY)
    flow_median_kernel(const float* __restrict__ in, float* __restrict__ out, int h, int w) {
  using P = Plan<K>;
  __shared__ __align__(16) int tile[2][P::kRows][P::kCols];  // keys of u and v
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const size_t img = static_cast<size_t>(blockIdx.z) * h * w;
  // a float a thread, in the flow's own order: (row, column, plane)
  for (int e = threadIdx.y * kThreadsX + threadIdx.x; e < 2 * P::kRows * P::kCols;
       e += kThreadsX * kThreadsY) {
    const int r = e / (2 * P::kCols), c = (e / 2) % P::kCols;
    const int gy = min(max(y0 + r - K / 2, 0), h - 1), gx = min(max(x0 + c - K / 2, 0), w - 1);
    tile[e & 1][r][c] = to_key(__ldg(in + 2 * (img + static_cast<size_t>(gy) * w + gx) + (e & 1)));
  }
  __syncthreads();
  const int ty = 2 * threadIdx.y, tx = 2 * threadIdx.x;  // the thread's union window's corner in tile
#pragma unroll 1
  for (int p = 0; p < 2; ++p) {
    int win[K + 1][K + 1];
#pragma unroll
    for (int i = 0; i <= K; ++i)
#pragma unroll
      for (int j = 0; j <= K; j += 2) {
        const int2 q = *reinterpret_cast<const int2*>(&tile[p][ty + i][tx + j]);
        win[i][j] = q.x;
        win[i][j + 1] = q.y;
      }
    median_2x2<K>(win, out, img, y0 + ty, x0 + tx, h, w, p);
  }
}

__global__ void __launch_bounds__(kGenericX* kGenericY)
    flow_median_generic_kernel(const float* __restrict__ in, float* __restrict__ out, int h, int w,
                               int k) {
  const int x = blockIdx.x * kGenericX + threadIdx.x, y = blockIdx.y * kGenericY + threadIdx.y;
  if (x >= w || y >= h) return;
  const size_t img = static_cast<size_t>(blockIdx.z) * h * w;
  const int r = k / 2, mid = k * k / 2;
  unsigned mu = 0, mv = 0;  // the medians' unsigned keys, built from the top bit
  for (int bit = 31; bit >= 0; --bit) {
    const unsigned tu = mu | (1u << bit), tv = mv | (1u << bit);
    int below_u = 0, below_v = 0;  // window keys below the trial keys
    for (int i = -r; i <= r; ++i) {
      const float* row = in + 2 * (img + static_cast<size_t>(min(max(y + i, 0), h - 1)) * w);
      for (int j = -r; j <= r; ++j) {
        const int c = 2 * min(max(x + j, 0), w - 1);
        below_u += to_ukey(__ldg(row + c)) < tu;
        below_v += to_ukey(__ldg(row + c + 1)) < tv;
      }
    }
    if (below_u <= mid) mu = tu;
    if (below_v <= mid) mv = tv;
  }
  const size_t o = 2 * (img + static_cast<size_t>(y) * w + x);
  out[o] = from_ukey(mu);
  out[o + 1] = from_ukey(mv);
}

}  // namespace

// k in {3, 5, 7, 9}; any other k returns cudaErrorInvalidValue.
extern "C" int ocvk_flow_median(const float* in, float* out, int nimg, int h, int w, int k,
                                void* stream) {
  const dim3 block(kThreadsX, kThreadsY);
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, nimg);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 3: flow_median_kernel<3><<<grid, block, 0, st>>>(in, out, h, w); break;
    case 5: flow_median_kernel<5><<<grid, block, 0, st>>>(in, out, h, w); break;
    case 7: flow_median_kernel<7><<<grid, block, 0, st>>>(in, out, h, w); break;
    case 9: flow_median_kernel<9><<<grid, block, 0, st>>>(in, out, h, w); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// any odd k with k * k < 2^31
extern "C" int ocvk_flow_median_generic(const float* in, float* out, int nimg, int h, int w, int k,
                                        void* stream) {
  const dim3 block(kGenericX, kGenericY);
  const dim3 grid((w + kGenericX - 1) / kGenericX, (h + kGenericY - 1) / kGenericY, nimg);
  flow_median_generic_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(in, out, h, w,
                                                                                    k);
  return static_cast<int>(cudaGetLastError());
}
