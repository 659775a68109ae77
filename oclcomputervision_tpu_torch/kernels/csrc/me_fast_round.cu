// One round of the fast (warp-based) block matching: warp frame 1 by the
// current per-pixel displacement state, cost the 3x3 candidate shifts at
// {-step, 0, +step} as ps x ps box sums of |f0 - shifted warp| (or its
// square), take the first minimum in row-major (dy, dx) order and move the
// state by it. f0, f1 [B, H, W] uint8, state planes dy, dx [B, H, W] int32
// (null: all zero) -> new state planes. The 3x3 median that closes a round
// is me_fast_median.cu.
//
// Replaces, together with me_fast_median.cu, the TPU kernel
// me_fast_residual_pallas (oclcomputervision_tpu/ops/pallas/me_fast_pallas.py,
// body _make_fast_kernel). That kernel runs all rounds in one call on row
// bands with a 17-row halo recomputed per band, and warps by masked selects
// over rotated copies of the band, because the TPU has no per-pixel read;
// that needs the state bounded, so it only takes the residual form. Here a
// round is one launch, a thread reads frame 1 where the state points, and
// the state may be any displacement (the residual form starts it at zero on
// a frame already warped by the seed; the gather form starts it at the seed).
//
// Semantics: _fast_rounds of oclcomputervision_tpu/ops/motion.py. With
// w1(p) = f1(p + state(p)) inside the image and 0 outside (both for p and for
// where it points), candidate o's cost at p is the zero-padded box sum over
// the ps x ps patch around p of D_o(r) = |f0(r) - w1(r + o)| (or its square)
// for r inside the image, 0 outside: the plain version's me_fast (an image
// of differences per candidate, then _boxsum). Integer sums are associative,
// so the separable running sums below are bit for bit the tap-by-tap sum.
//
// What bounds it on the H100: device memory, once the costs are separable.
// A launch reads 2 bytes of frames and 8 of state per pixel and writes 8 of
// state (56.5 MB per 3 launches at 4 x 480 x 640: 0.0169 ms at 3.35 TB/s);
// the box-sum form does about 75 integer operations per pixel (9 candidates
// x (2 differences and 2 adds of the vertical running sum, 3 adds of the
// horizontal sum, 1 compare)). The first form summed every candidate
// tap by tap from shared memory: 225 taps, each two byte loads and three
// operations, plus bounds tests per tap (0.34 ms per 3 launches, 9.2x that
// form's own operation bound).
// Design. A block of 16 warps takes a tile of 48 rows x 4 (32 - 2 pm)
// columns of one image (pm = ps / 2; 112 columns at patch 5): 4 warps side
// by side, 4 stacked, each warp 12 rows. It stages the warped frame over the
// tile plus a halo of step + pm (the state read as int4 where a row allows
// it, one scattered byte load of frame 1 per staged pixel) and frame 0 plus
// a halo of pm, as bytes in shared memory. Lane l of a warp owns one column
// of the warp's 32, the warp's 32 - 2 pm outputs and pm columns on each
// side, and walks down its 12 rows keeping the vertical running sum of each
// candidate's differences (add the row entering the window, subtract the
// one leaving it; lanes read consecutive bytes, conflict-free). The
// horizontal box sum is built from warp shuffles by doubling (ps = 5: three
// shuffles per sum), then the first minimum and the state update are
// written by the lanes that own an output. Rows and columns outside the
// image contribute nothing, tested once per row and once per lane, never per
// tap. SAD at patches up to 15 (kSadPacked) keeps two candidates' sums in
// the 16-bit halves of a word: a staged word holds the warped frame at the
// column - step, the column and the column + step, so one __vabsdiffu4 gives
// a candidate row's three differences, and five words carry the nine sums
// through the shuffles. SSD, and SAD at patches 17-31, keep nine ints.
// Patches up to 31 (pm <= 15) fit a warp.
// Measured (NVIDIA H100 80GB HBM3, 700 W power limit; kernels/forms.py, three
// rounds at 4 x 480 x 640): 0.0748 ms per 3 launches, against 0.3411 for
// the first form; one int per candidate 0.0930, the packed form with 8
// warps of 16 rows 0.0818 and of 8 rows 0.0763, with four staged chunks in
// flight per thread 0.0872 (PERF.md). What is left is instruction issue: about 145
// instructions per warp and row step; without the shuffles' sums it took
// 0.0611-0.0639.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kWarpsX = 4;        // warps side by side
constexpr int kWarpsY = 4;        // warps stacked
constexpr int kRowsPerWarp = 12;  // output rows each warp walks down
constexpr int kThreads = 32 * kWarpsX * kWarpsY;
constexpr int kTileH = kWarpsY * kRowsPerWarp;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxPm = 15;  // a warp's 32 columns hold pm + 1 outputs' window at least

struct Tile {
  int pm, step;
  int ow;       // output columns per warp
  int tw;       // output columns per block (a multiple of 4)
  int hw, hwa;  // warped-frame halo (step + pm) and its columns rounded up to 4
  int ww, wh;   // warped tile columns and rows
  int pa;       // frame-0 column halo (pm rounded up to 4)
  int aw, ah;   // frame-0 tile columns and rows
};

__host__ __device__ inline Tile tile_of(int pm, int step) {
  Tile t;
  t.pm = pm;
  t.step = step;
  t.ow = 32 - 2 * pm;
  t.tw = kWarpsX * t.ow;
  t.hw = step + pm;
  t.hwa = (t.hw + 3) / 4 * 4;
  t.ww = t.tw + 2 * t.hwa;
  t.wh = kTileH + 2 * t.hw;
  t.pa = (pm + 3) / 4 * 4;
  t.aw = t.tw + 2 * t.pa;
  t.ah = kTileH + 2 * pm;
  return t;
}

template <bool SSD>
__device__ __forceinline__ int cost_of(int a, int b) {
  const int d = a - b;
  return SSD ? d * d : abs(d);
}

// the horizontal box sum over lanes lane .. lane + ps - 1 of each of N
// registers, by doubling: part sums `width` columns from the lane, cost the
// bits of ps done so far (ps is odd: its lowest bit is the lane's own column).
// Packed 16-bit pairs add as one 32-bit word while no half passes 65535.
template <int N, typename T>
__device__ __forceinline__ void box_sum_lanes(const T (&v)[N], T (&cost)[N], int ps) {
  T part[N];
#pragma unroll
  for (int k = 0; k < N; ++k) part[k] = cost[k] = v[k];
  int done = 1, width = 1;
  for (int rem = ps >> 1; rem != 0; rem >>= 1) {
#pragma unroll
    for (int k = 0; k < N; ++k) part[k] += __shfl_down_sync(kFull, part[k], width);
    width *= 2;
    if (rem & 1) {
#pragma unroll
      for (int k = 0; k < N; ++k) cost[k] += __shfl_down_sync(kFull, part[k], done);
      done += width;
    }
  }
}

// MODE: kSad and kSsd keep one int per candidate; kSadPacked keeps SAD sums
// two to a word in 16-bit halves (ps <= 15: 15 * 15 * 255 < 65536) and
// computes three candidates' differences at once from a staged word.
constexpr int kSad = 0, kSsd = 1, kSadPacked = 2;
constexpr int kMaxPackedPm = 7;

template <int MODE>
__global__ void __launch_bounds__(kThreads)
    me_fast_round_kernel(const uint8_t* __restrict__ f0, const uint8_t* __restrict__ f1,
                         const int* __restrict__ dy_in, const int* __restrict__ dx_in,
                         int* __restrict__ dy_out, int* __restrict__ dx_out, int h, int w,
                         int pm, int step, bool vec_state) {
  constexpr bool SSD = MODE == kSsd;
  extern __shared__ uint32_t smem_words[];
  const Tile tl = tile_of(pm, step);
  uint8_t* w1s = reinterpret_cast<uint8_t*>(smem_words);  // [wh][ww]
  uint8_t* f0s = w1s + tl.ww * tl.wh;                       // [ah][aw]
  // kSadPacked: [wh][tw + 2 pm] words, bytes 0-2 the warped frame at the
  // word's column - step, the column, the column + step (byte 3 zero)
  uint32_t* w3s = smem_words + (tl.ww * tl.wh + tl.aw * tl.ah) / 4;
  const int w3w = tl.tw + 2 * pm;
  const size_t img = static_cast<size_t>(blockIdx.z) * h * w;
  f0 += img;
  f1 += img;
  const int x0 = blockIdx.x * tl.tw;
  const int y0 = blockIdx.y * kTileH;

  // the warped frame, four columns (one word) per step
  const int wchunks = tl.ww / 4;
  for (int i = threadIdx.x; i < tl.wh * wchunks; i += kThreads) {
    const int r = i / wchunks;
    const int y = y0 - tl.hw + r;
    const int xc = x0 - tl.hwa + 4 * (i - r * wchunks);
    uint32_t word = 0;
    if (y >= 0 && y < h) {
      const size_t p = img + static_cast<size_t>(y) * w + xc;
      int sy[4], sx[4];
      if (dy_in != nullptr && vec_state && xc >= 0 && xc + 3 < w) {
        const int4 vy = __ldg(reinterpret_cast<const int4*>(dy_in + p));
        const int4 vx = __ldg(reinterpret_cast<const int4*>(dx_in + p));
        sy[0] = vy.x; sy[1] = vy.y; sy[2] = vy.z; sy[3] = vy.w;
        sx[0] = vx.x; sx[1] = vx.y; sx[2] = vx.z; sx[3] = vx.w;
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const bool in = xc + k >= 0 && xc + k < w;
          sy[k] = (in && dy_in != nullptr) ? __ldg(dy_in + p + k) : 0;
          sx[k] = (in && dx_in != nullptr) ? __ldg(dx_in + p + k) : 0;
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int x = xc + k;
        const int ty = y + sy[k], tx = x + sx[k];
        if (x >= 0 && x < w && ty >= 0 && ty < h && tx >= 0 && tx < w)
          word |= static_cast<uint32_t>(__ldg(f1 + static_cast<size_t>(ty) * w + tx)) << (8 * k);
      }
    }
    smem_words[i] = word;
  }
  // frame 0 (0 outside the image; those rows and columns are never summed)
  uint32_t* f0w = smem_words + tl.ww * tl.wh / 4;
  const int achunks = tl.aw / 4;
  for (int i = threadIdx.x; i < tl.ah * achunks; i += kThreads) {
    const int r = i / achunks;
    const int y = y0 - pm + r;
    const int xc = x0 - tl.pa + 4 * (i - r * achunks);
    uint32_t word = 0;
    if (y >= 0 && y < h) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (xc + k >= 0 && xc + k < w)
          word |= static_cast<uint32_t>(__ldg(f0 + static_cast<size_t>(y) * w + xc + k)) << (8 * k);
      }
    }
    f0w[i] = word;
  }
  __syncthreads();
  if (MODE == kSadPacked) {
    for (int i = threadIdx.x; i < tl.wh * w3w; i += kThreads) {
      const int r = i / w3w;
      const uint8_t* b = w1s + r * tl.ww + tl.hwa - pm + (i - r * w3w);
      w3s[i] = b[-step] | (static_cast<uint32_t>(b[0]) << 8) | (static_cast<uint32_t>(b[step]) << 16);
    }
    __syncthreads();
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wx = warp % kWarpsX;
  const int wy = warp / kWarpsX;
  const int xw = x0 + wx * tl.ow;  // the warp's first output column
  const int ys = y0 + wy * kRowsPerWarp;
  if (xw >= w || ys >= h) return;  // warp-uniform: nothing of this warp is in the image
  const int c = xw - pm + lane;    // the lane's column
  const bool col_in = c >= 0 && c < w;
  const uint8_t* f0c = f0s + (c - (x0 - tl.pa));   // frame-0 tile, row 0 = y0 - pm
  const uint8_t* w1c = w1s + (c - (x0 - tl.hwa));  // warped tile, row 0 = y0 - hw
  const uint32_t* w3c = w3s + (c - (x0 - pm));     // packed warped tile, row 0 = y0 - hw
  const int ps = 2 * pm + 1;
  const int x = xw + lane;  // the lane's output column
  const bool out_lane = lane < tl.ow && x < w;
  auto store = [&](int y, int best_k) {
    const size_t p = img + static_cast<size_t>(y) * w + x;
    dy_out[p] = (dy_in != nullptr ? __ldg(dy_in + p) : 0) + (best_k / 3 - 1) * step;
    dx_out[p] = (dx_in != nullptr ? __ldg(dx_in + p) : 0) + (best_k % 3 - 1) * step;
  };

  if (MODE == kSadPacked) {
    // candidate k = 3 i + j (row i, column j of the 3 x 3 shifts): lo[i]
    // holds k = 3i (low half) and 3i + 1 (high half); mid holds 2 and 5,
    // last holds 8
    uint32_t v[5] = {0, 0, 0, 0, 0};  // lo[0], lo[1], lo[2], mid, last
    auto row_costs = [&](int r, bool add) {
      if (r < 0 || r >= h || !col_in) return;
      const uint32_t a3 = f0c[(r - (y0 - pm)) * tl.aw] * 0x00010101u;
      const uint32_t* wr = w3c + (r - (y0 - tl.hw)) * w3w;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const uint32_t d = __vabsdiffu4(a3, wr[(i - 1) * step * w3w]);
        const uint32_t lo = __byte_perm(d, 0, 0x4140);  // bytes 0, 1 to the halves
        // byte 2 to the low half (rows 0 and 2) or the high half (row 1)
        const uint32_t hi = __byte_perm(d, 0, i == 1 ? 0x4244 : 0x4442);
        if (add) {
          v[i] += lo;
          v[i == 2 ? 4 : 3] += hi;
        } else {
          v[i] -= lo;
          v[i == 2 ? 4 : 3] -= hi;
        }
      }
    };
    for (int r = ys - pm; r < ys + pm; ++r) row_costs(r, true);
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int y = ys + i;
      if (y >= h) break;  // warp-uniform
      row_costs(y + pm, true);
      uint32_t cost[5];
      box_sum_lanes<5>(v, cost, ps);
      if (out_lane) {
        // the first minimum in (dy, dx) order: the least of cost * 16 + k
        uint32_t key = (cost[0] & 0xffffu) << 4;
        key = min(key, (cost[0] >> 16) << 4 | 1u);
        key = min(key, (cost[3] & 0xffffu) << 4 | 2u);
        key = min(key, (cost[1] & 0xffffu) << 4 | 3u);
        key = min(key, (cost[1] >> 16) << 4 | 4u);
        key = min(key, (cost[3] >> 16) << 4 | 5u);
        key = min(key, (cost[2] & 0xffffu) << 4 | 6u);
        key = min(key, (cost[2] >> 16) << 4 | 7u);
        key = min(key, cost[4] << 4 | 8u);
        store(y, static_cast<int>(key & 15u));
      }
      row_costs(y - pm, false);
    }
    return;
  }

  int off[9];  // candidate k's offset in the warped tile
#pragma unroll
  for (int k = 0; k < 9; ++k) off[k] = (k / 3 - 1) * step * tl.ww + (k % 3 - 1) * step;
  int v[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) v[k] = 0;
  // the vertical window's differences of image row r, added or removed
  auto row_costs = [&](int r, int sign) {
    if (r < 0 || r >= h || !col_in) return;
    const int a = f0c[(r - (y0 - pm)) * tl.aw];
    const uint8_t* wr = w1c + (r - (y0 - tl.hw)) * tl.ww;
#pragma unroll
    for (int k = 0; k < 9; ++k) v[k] += sign * cost_of<SSD>(a, wr[off[k]]);
  };
  for (int r = ys - pm; r < ys + pm; ++r) row_costs(r, 1);
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int y = ys + i;
    if (y >= h) break;  // warp-uniform
    row_costs(y + pm, 1);
    int cost[9];
    box_sum_lanes<9>(v, cost, ps);
    if (out_lane) {
      int best = cost[0], best_k = 0;
#pragma unroll
      for (int k = 1; k < 9; ++k) {
        if (cost[k] < best) {  // strict: the first minimum in (dy, dx) order wins
          best = cost[k];
          best_k = k;
        }
      }
      store(y, best_k);
    }
    row_costs(y - pm, -1);
  }
}

}  // namespace

// dy_in and dx_in may both be null (a state of zeros). Odd patch sizes up to
// 31; the block's shared memory grows with step and ps, and a geometry that
// exceeds the card's limit is refused with cudaErrorInvalidValue.
extern "C" int ocvk_me_fast_round(const uint8_t* f0, const uint8_t* f1, const int* dy_in,
                                  const int* dx_in, int* dy_out, int* dx_out, int nimg, int h,
                                  int w, int ps, int step, int ssd, void* stream) {
  if (ps < 1 || ps % 2 == 0 || ps / 2 > kMaxPm || step < 1 || nimg > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int pm = ps / 2;
  const Tile tl = tile_of(pm, step);
  const int mode = ssd ? kSsd : (pm <= kMaxPackedPm ? kSadPacked : kSad);
  size_t bytes = static_cast<size_t>(tl.ww) * tl.wh + static_cast<size_t>(tl.aw) * tl.ah;
  if (mode == kSadPacked) bytes += sizeof(uint32_t) * tl.wh * (tl.tw + 2 * pm);
  if (bytes > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = mode == kSsd ? me_fast_round_kernel<kSsd>
                : mode == kSad ? me_fast_round_kernel<kSad> : me_fast_round_kernel<kSadPacked>;
  if (bytes > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  // int4 state loads where every row starts on a 16-byte boundary
  const bool vec = w % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(dy_in) | reinterpret_cast<uintptr_t>(dx_in)) & 15u) == 0;
  const dim3 grid((w + tl.tw - 1) / tl.tw, (h + kTileH - 1) / kTileH, nimg);
  kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      f0, f1, dy_in, dx_in, dy_out, dx_out, h, w, ps / 2, step, vec);
  return static_cast<int>(cudaGetLastError());
}
