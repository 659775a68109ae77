// Separable bilinear / bicubic resize of channels-last images in one pass.
//
// Replaces no TPU kernel: the JAX package's resize (ops/interpolation.py) is
// plain jnp, rows then columns, each pass a sum over its taps. Its PyTorch
// port ran the same passes as torch ops (ops/interpolation._resize_passes):
// per tap an index_select, a multiply and an out-of-place add, over rows and
// then over columns, with the uint8 -> f32 copy of the input, zero fills and
// the quantisation around them: about 26 passes over f32 copies, the largest
// block of device time in EnhancePipeline's call. This kernel does the whole
// resize in one launch, from the input's own type to the output's.
//
// What it computes, bit for bit the same as the passes: for output element
// (b, y, x, c) and each column tap j in order,
//   r_j = 0 + sum_k yw[k][y] * in[b, yidx[k][y], xidx[j][x], c]
// and then o = 0 + sum_j xw[j][x] * r_j, every product and sum rounded
// separately (__fmul_rn / __fadd_rn: nothing contracted or reordered). r_j
// is exactly the row pass's intermediate at (y, xidx[j][x]), so o is the
// column pass's result. The tables are the host's f32 weights and int64
// indices (ops/interpolation._axis_table, or a band's row table), [taps, n].
// Then the store: f32 raw, or clamped to [0, hi] (torch.clamp, NaN kept);
// uint8: that clamp, rintf (half to even, as torch.round), a clamp to
// [0, 255] and the cast.
//
// Its bound on the H100 is device memory: it reads the input once and
// writes the output once (at EnhancePipeline's 16 x 1440 x 2560 -> 1080 x
// 1920 uint8 call: 59.0 MB in, 33.2 MB out, 0.0275 ms at 3.35 TB/s) and does
// a few dozen flops per output element (what holds it back in practice is
// below).
//
// Design: a block of 256 threads owns a tile of tile_h output rows x tile_w
// flattened output elements (pixels x channels) of one image.
//  - One round of table loads: the tile's row taps into shared memory, each
//    lane's column taps into registers (a warp owns a chunk of 128 output
//    elements, a lane 4 of them 32 apart). The min and max over them give
//    the window of input rows and columns the tile reaches, so any table
//    works, monotone or not.
//  - Staged form: the window goes to shared memory as f32, a warp a row, 4
//    elements a lane (4- or 16-byte loads where the rows allow: row bytes
//    and the base a multiple of 16, the window's start aligned down; several
//    rows' loads in flight before their stores). uint8 widens on the ALUs
//    (2^23 + b as bits, minus 2^23), once an input element: the conversion
//    unit runs at an eighth of the FP32 rate, and converting at every tap
//    took most of the first form's time. The vertical pass writes a shared
//    f32 buffer for the tile's rows x the window's elements (a warp a row,
//    4 consecutive elements a lane); the horizontal pass reads it with lanes
//    on consecutive output elements, about a word apart (spread over the
//    banks; 4 consecutive elements a lane read 5.3 words apart at a 4/3
//    downscale, a 6-way conflict), and a warp's stores are one contiguous
//    run. A uint8 store rounds by adding 1.5 x 2^23 (half to even, as
//    rintf) and keeps the low byte: no conversion unit there either.
//  - Direct form: where the window does not fit the shared memory the host
//    sized (span_h rows, pitch elements), or the host asked for it (span_h
//    == 0: a downscale by the tap count or more, where the window holds
//    pixels no tap reads), the block computes each r_j from device memory
//    through the read-only cache instead. Same arithmetic, same order, same
//    bits. The choice is made per block, so no valid shape is refused.
//  - Taps (2 bilinear, 4 bicubic) and the input and output types are
//    template constants; the channel count C and the tile are read at run
//    time. One grid dimension over (image, tile row, tile column).
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (see PERF.md): 0.113 ms at
// the enhance call (16 x 1440 x 2560 -> 1080 x 1920, bicubic, uint8; 24 %
// of its bytes bound) against 4.1 ms for the plain passes. It is bound by
// instruction throughput, not by bytes: about 45 instructions an output
// element (two passes of 4 separately rounded products and sums, the
// widening, the store) at 40 % of the rate the SMs can dispatch them. The
// forms tried there, in turn: 4 consecutive elements a lane and the tables
// read in each phase, 0.30 ms; lanes 32 apart and one round of table
// loads, 0.18; the window widened to f32 once at staging, 0.21 (98
// registers: 2 blocks an SM); one element a lane with uint8 widened on the
// ALUs, 0.12 (64 registers, 4 blocks); tiles of 24 rows, 0.113; bands of
// sub-tiles with the next window's cp.async copies in flight, 0.121
// (faster only for upscales, so left out).
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTileH = 32;  // output rows a tile may have
constexpr int kRowsInFlight = 4;  // window rows a warp loads before it stores them

// uint8 -> f32 on the ALUs: 0x4B0000bb is 2^23 + b, so subtracting 2^23 is
// exact (I2F runs at an eighth of the FP32 rate)
__device__ __forceinline__ float byte_f32(unsigned word, int i) {
  return __int_as_float(__byte_perm(word, 0x4B000000u, 0x7540 + i)) - 8388608.0f;
}
__device__ __forceinline__ float as_f32(uint8_t v) { return byte_f32(v, 0); }
__device__ __forceinline__ float as_f32(float v) { return v; }

// four consecutive staged elements as f32 (aligned rows in shared memory)
__device__ __forceinline__ void load4(const uint8_t* p, float v[4]) {
  const unsigned w = *reinterpret_cast<const unsigned*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = byte_f32(w, i);
}
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

// torch.clamp(v, 0, hi): NaN stays NaN
__device__ __forceinline__ float clamp_to(float v, float hi) {
  return v < 0.0f ? 0.0f : (v > hi ? hi : v);
}

// f32 out: raw, or the bicubic clamp
__device__ __forceinline__ void store(float* p, float o, int clamp, float hi) {
  *p = clamp ? clamp_to(o, hi) : o;
}
// uint8 out: clamp(round(clamp(o, 0, hi)), 0, 255) as torch computes it. hi is
// 1 or 255 (else 255: no clamp), so rounding after both clamps is the same;
// adding 1.5 x 2^23 rounds half to even (as torch.round) and leaves the
// integer in the low byte.
__device__ __forceinline__ void store(uint8_t* p, float o, int clamp, float hi) {
  o = fminf(fmaxf(o, 0.0f), clamp ? hi : 255.0f);
  *p = static_cast<uint8_t>(__float_as_uint(__fadd_rn(o, 12582912.0f)));
}

// sum_k w[k] * v[k] in order, each product and sum rounded. The plain
// passes start from 0 + p; that add only turns a -0 into +0, and is left
// out where the sign of a zero cannot reach the output: in a row-pass
// value (the column sum starts at +0 and stays +0 while it adds zeros, so
// the sign of a zero product never shows) and before a uint8 store.
template <int T, bool kFromZero>
__device__ __forceinline__ float dot(const float w[T], const float v[T]) {
  float acc = kFromZero ? __fadd_rn(0.0f, __fmul_rn(w[0], v[0])) : __fmul_rn(w[0], v[0]);
#pragma unroll
  for (int k = 1; k < T; ++k) acc = __fadd_rn(acc, __fmul_rn(w[k], v[k]));
  return acc;
}

template <int T, typename Tin, typename Tout>
__global__ void __launch_bounds__(kThreads) resize_sep_kernel(
    const Tin* __restrict__ x, Tout* __restrict__ out,
    const long long* __restrict__ yidx, const float* __restrict__ yw,
    const long long* __restrict__ xidx, const float* __restrict__ xw, int h_in,
    int w_in, int h_out, int w_out, int nch, int tile_h, int tile_w,
    int tiles_y, int tiles_x, int span_h, int pitch, int vec_in, int clamp,
    float hi) {
  constexpr bool kOutF32 = sizeof(Tout) == 4;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int ry[kMaxTileH][T];
  __shared__ float rw[kMaxTileH][T];
  __shared__ int reach[4];  // row min, row max, column min, column max

  int bid = blockIdx.x;
  const int tj = bid % tiles_x;
  bid /= tiles_x;
  const int ti = bid % tiles_y;
  const int n = bid / tiles_y;
  const int row_in = w_in * nch;   // elements in an input row
  const int row_out = w_out * nch;  // elements in an output row
  const int y0 = ti * tile_h;
  const int rows = min(tile_h, h_out - y0);
  const int e0 = tj * tile_w;
  const int e_end = min(e0 + tile_w, row_out);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nchunk = (e_end - e0 + 31) / 32;  // 32-element chunks of the tile

  // One round of table loads. The tile's row taps go to shared memory. A
  // warp owns the tile's 32-element chunks warp, warp + 8, ...; a lane keeps
  // its element's column taps in registers for the first, and the lanes'
  // elements over all chunks give the tile's column reach.
  if (threadIdx.x == 0) {
    reach[0] = INT_MAX; reach[1] = INT_MIN; reach[2] = INT_MAX; reach[3] = INT_MIN;
  }
  int lo = INT_MAX, top = INT_MIN;
  if (threadIdx.x < rows * T) {
    const int ii = threadIdx.x / T;
    const int k = threadIdx.x - ii * T;
    lo = top = static_cast<int>(yidx[static_cast<size_t>(k) * h_out + y0 + ii]);
    ry[ii][k] = lo;
    rw[ii][k] = yw[static_cast<size_t>(k) * h_out + y0 + ii];
  }
  int col[T];
  float cw[T];
  auto column = [&](int chunk) {  // the lane's element's taps in a chunk
    const int e = min(e0 + 32 * chunk + lane, e_end - 1);
    const int px = nch == 1 ? e : e / nch;
    const int c = e - px * nch;
#pragma unroll
    for (int j = 0; j < T; ++j) {
      col[j] = static_cast<int>(xidx[static_cast<size_t>(j) * w_out + px]) * nch + c;
      cw[j] = xw[static_cast<size_t>(j) * w_out + px];
    }
  };
  int clo = INT_MAX, chi = INT_MIN;
  for (int chunk = warp; chunk < nchunk; chunk += kWarps) {
    column(chunk);
#pragma unroll
    for (int j = 0; j < T; ++j) {
      clo = min(clo, col[j]);
      chi = max(chi, col[j]);
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, d));
    top = max(top, __shfl_xor_sync(0xffffffffu, top, d));
    clo = min(clo, __shfl_xor_sync(0xffffffffu, clo, d));
    chi = max(chi, __shfl_xor_sync(0xffffffffu, chi, d));
  }
  __syncthreads();  // reach initialised, the row taps stored
  if (lane == 0) {
    atomicMin(&reach[0], lo);
    atomicMax(&reach[1], top);
    atomicMin(&reach[2], clo);
    atomicMax(&reach[3], chi);
  }
  __syncthreads();
  const int ylo = reach[0];
  const int nrow = reach[1] - ylo + 1;
  // the staged window's first element and length, in input elements of a
  // row (the reach is in elements: pixel x nch + channel)
  constexpr int kUnit = 16 / sizeof(Tin);  // elements in 16 bytes
  int s0 = reach[2] - reach[2] % nch;
  int need = reach[3] + nch - reach[3] % nch - s0;
  if (vec_in) {
    const int a = s0 - s0 % kUnit;
    need = (need + s0 - a + kUnit - 1) / kUnit * kUnit;
    s0 = a;
  }
  const bool staged = span_h > 0 && nrow <= span_h && need <= pitch;

  Tin* xs = reinterpret_cast<Tin*>(smem);
  float* vs = reinterpret_cast<float*>(smem + static_cast<size_t>(span_h) * pitch * sizeof(Tin));
  if (staged) {
    // a warp a window row, 16 bytes a lane where the rows allow (else one
    // element), kRowsInFlight rows' loads in flight before their stores
    const Tin* src = x + (static_cast<size_t>(n) * h_in + ylo) * row_in + s0;
    if (vec_in) {
      const int per_row = need / kUnit;
      for (int r0 = warp; r0 < nrow; r0 += kRowsInFlight * kWarps)
        for (int q = lane; q < per_row; q += 32) {
          int4 buf[kRowsInFlight];
#pragma unroll
          for (int i = 0; i < kRowsInFlight; ++i) {
            const int r = r0 + i * kWarps;
            if (r < nrow)
              buf[i] = __ldg(reinterpret_cast<const int4*>(src + static_cast<size_t>(r) * row_in) + q);
          }
#pragma unroll
          for (int i = 0; i < kRowsInFlight; ++i) {
            const int r = r0 + i * kWarps;
            if (r < nrow) reinterpret_cast<int4*>(xs + r * pitch)[q] = buf[i];
          }
        }
    } else {
      for (int r = warp; r < nrow; r += kWarps)
        for (int q = lane; q < need; q += 32)
          xs[r * pitch + q] = __ldg(src + static_cast<size_t>(r) * row_in + q);
    }
    __syncthreads();
    // vertical pass: a warp a tile row, 4 consecutive window elements a lane
    for (int ii = warp; ii < rows; ii += kWarps) {
      const Tin* xr[T];
      float w[T];
#pragma unroll
      for (int k = 0; k < T; ++k) {
        xr[k] = xs + (ry[ii][k] - ylo) * pitch;
        w[k] = rw[ii][k];
      }
      for (int g = 4 * lane; g < need; g += 128) {
        float v[T][4];
#pragma unroll
        for (int k = 0; k < T; ++k) load4(xr[k] + g, v[k]);
        float acc[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float a[T];
#pragma unroll
          for (int k = 0; k < T; ++k) a[k] = v[k][q];
          acc[q] = dot<T, false>(w, a);
        }
        *reinterpret_cast<float4*>(vs + ii * pitch + g) = make_float4(acc[0], acc[1], acc[2], acc[3]);
      }
    }
    __syncthreads();
  }

  // horizontal pass: a warp walks the rows of each of its chunks, a lane on
  // one element (lanes a word or so apart in the buffer, spread over the
  // banks; a warp's stores one contiguous run)
  for (int chunk = warp; chunk < nchunk; chunk += kWarps) {
    column(chunk);
    const int e = e0 + 32 * chunk + lane;
    if (e >= e_end) continue;
#pragma unroll
    for (int j = 0; j < T; ++j) col[j] -= s0;  // the direct form adds s0 back
    for (int ii = 0; ii < rows; ++ii) {
      float r[T];
      if (staged) {
        const float* v = vs + ii * pitch;
#pragma unroll
        for (int j = 0; j < T; ++j) r[j] = v[col[j]];
      } else {
        const Tin* src[T];
        float w[T];
#pragma unroll
        for (int k = 0; k < T; ++k) {
          src[k] = x + (static_cast<size_t>(n) * h_in + ry[ii][k]) * row_in + s0;
          w[k] = rw[ii][k];
        }
#pragma unroll
        for (int j = 0; j < T; ++j) {
          float v[T];
#pragma unroll
          for (int k = 0; k < T; ++k) v[k] = as_f32(__ldg(src[k] + col[j]));
          r[j] = dot<T, false>(w, v);
        }
      }
      store(out + (static_cast<size_t>(n) * h_out + y0 + ii) * row_out + e,
            dot<T, kOutF32>(cw, r), clamp, hi);
    }
  }
}

template <int T, typename Tin, typename Tout>
cudaError_t launch(const void* x, void* out, const long long* yidx, const float* yw,
                   const long long* xidx, const float* xw, int nimg, int h_in, int w_in,
                   int h_out, int w_out, int nch, int tile_h, int tile_w, int span_h,
                   int pitch, int vec_in, int clamp, float hi, cudaStream_t stream) {
  const int tiles_y = (h_out + tile_h - 1) / tile_h;
  const int tiles_x = (w_out * nch + tile_w - 1) / tile_w;
  const long long blocks = static_cast<long long>(nimg) * tiles_y * tiles_x;
  const size_t dyn = span_h > 0 ? static_cast<size_t>(span_h) * pitch * sizeof(Tin) +
                                      static_cast<size_t>(tile_h) * pitch * sizeof(float)
                                : 0;
  if (blocks > 2147483647LL || dyn > 200 * 1024) return cudaErrorInvalidValue;
  if (dyn > 32 * 1024) {  // with the static tables, past the 48 KB a block gets unasked
    const cudaError_t err = cudaFuncSetAttribute(
        resize_sep_kernel<T, Tin, Tout>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(dyn));
    if (err != cudaSuccess) return err;
  }
  resize_sep_kernel<T, Tin, Tout><<<static_cast<unsigned int>(blocks), kThreads, dyn, stream>>>(
      static_cast<const Tin*>(x), static_cast<Tout*>(out), yidx, yw, xidx, xw, h_in, w_in,
      h_out, w_out, nch, tile_h, tile_w, tiles_y, tiles_x, span_h, pitch, vec_in, clamp, hi);
  return cudaGetLastError();
}

template <int T>
cudaError_t launch_types(int in_u8, int out_u8, const void* x, void* out,
                         const long long* yidx, const float* yw, const long long* xidx,
                         const float* xw, int nimg, int h_in, int w_in, int h_out, int w_out,
                         int nch, int tile_h, int tile_w, int span_h, int pitch, int vec_in,
                         int clamp, float hi, cudaStream_t st) {
  if (in_u8 && out_u8)
    return launch<T, uint8_t, uint8_t>(x, out, yidx, yw, xidx, xw, nimg, h_in, w_in, h_out,
                                       w_out, nch, tile_h, tile_w, span_h, pitch, vec_in,
                                       clamp, hi, st);
  if (in_u8)
    return launch<T, uint8_t, float>(x, out, yidx, yw, xidx, xw, nimg, h_in, w_in, h_out,
                                     w_out, nch, tile_h, tile_w, span_h, pitch, vec_in, clamp,
                                     hi, st);
  if (out_u8)
    return launch<T, float, uint8_t>(x, out, yidx, yw, xidx, xw, nimg, h_in, w_in, h_out,
                                     w_out, nch, tile_h, tile_w, span_h, pitch, vec_in, clamp,
                                     hi, st);
  return launch<T, float, float>(x, out, yidx, yw, xidx, xw, nimg, h_in, w_in, h_out, w_out,
                                 nch, tile_h, tile_w, span_h, pitch, vec_in, clamp, hi, st);
}

}  // namespace

// x: [nimg, h_in, w_in, nch] uint8 (in_u8) or f32; out: [nimg, h_out, w_out,
// nch] uint8 (out_u8) or f32; yidx, yw: [taps, h_out]; xidx, xw: [taps,
// w_out] (int64 indices into the axis, f32 weights). taps 2 or 4. The tile:
// tile_h <= 32 rows x tile_w >= 1 elements; the window takes span_h rows of
// pitch input elements (a multiple of 16 bytes) and the row pass tile_h
// rows of pitch f32, span_h 0 for the direct form everywhere.
// vec_in: 16-byte loads (x and its rows 16-byte aligned). clamp: clamp to
// [0, hi] first (hi 1 or 255 for a uint8 output).
extern "C" int ocvk_resize_sep(const void* x, void* out, const long long* yidx,
                               const float* yw, const long long* xidx, const float* xw,
                               int nimg, int h_in, int w_in, int h_out, int w_out, int nch,
                               int taps, int in_u8, int out_u8, int tile_h, int tile_w,
                               int span_h, int pitch, int vec_in, int clamp, float hi,
                               void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int unit = in_u8 ? 16 : 4;
  if (tile_h < 1 || tile_h > kMaxTileH || tile_w < 1 || span_h < 0 || pitch < 0 || pitch % unit != 0 || nimg < 1 || h_in < 1 || w_in < 1 ||
      h_out < 1 || w_out < 1 || nch < 1 || (out_u8 && clamp && !(hi == 1.0f || hi == 255.0f)))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (taps) {
    case 2:
      return static_cast<int>(launch_types<2>(in_u8, out_u8, x, out, yidx, yw, xidx, xw, nimg,
                                              h_in, w_in, h_out, w_out, nch, tile_h, tile_w,
                                              span_h, pitch, vec_in, clamp, hi, st));
    case 4:
      return static_cast<int>(launch_types<4>(in_u8, out_u8, x, out, yidx, yw, xidx, xw, nimg,
                                              h_in, w_in, h_out, w_out, nch, tile_h, tile_w,
                                              span_h, pitch, vec_in, clamp, hi, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
