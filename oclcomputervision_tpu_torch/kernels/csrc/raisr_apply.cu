// RAISR per-pixel filter select and apply in parity-plane space.
//
// Replaces the TPU kernel oclcomputervision_tpu/ops/pallas/raisr_pallas.py,
// _apply_phase (body _make_kernel; wrapper apply_filters_planes).
//
// Output pixel (y, x) of phase t = (py, px) of image n:
//   out = sum_q bf16(tap_q) * bf16(bank[t][bucket][q]),  q = ti*fl + tj,
// where tap_q is plane ((py - m + ti) mod s, (px - m + tj) mod s) at plane
// (y + hp + floor((py - m + ti)/s), x + hp + floor((px - m + tj)/s)) and
// bucket = buckets[n % B][t][y][x]: colour channels stacked into the batch
// share the luma bucket map. bf16 x bf16 products are exact in f32, so the
// only freedom is the summation order; the plain PyTorch version and this
// kernel both sum q = 0..fl*fl-1 in order, one fmaf per tap and pixel. A
// bucket outside [0, nbucket) selects nothing and gives 0, as the TPU kernel's
// one-hot select does.
//
// Why no tensor cores: the TPU form computes all 216 bucket responses as one
// [224,128] @ [128, N] matrix-unit product and then a one-hot select. That is
// 216x the useful work (3.5 PFLOP at 16 x 2048^2 output pixels: seconds even
// at the card's 989 TFLOP/s), and with a different filter per pixel there is
// no operand shared between pixels for wgmma or mma.sync to multiply. This is
// the direct select on the FMA pipe.
//
// What bounds it on the H100. Device memory is not it: 841 MB move at the
// bench shape (16 x 1024^2 -> 2048^2), 0.251 ms at 3.35 TB/s. The floor of
// the direct select is tighter: 121 FMAs per pixel are 0.274 ms at 132 SMs x
// 128 FMA/clk x 1.755 GHz, and each pixel reads its own 242 bytes of bf16
// filter row from shared memory, 0.548 ms at 128 B/clk/SM if every 4-byte
// load of a warp hit 32 different banks. It does not: the 32 lanes read
// rows of different buckets, and rows whose index is equal mod 32 share a
// bank. On the noisy natural images of the bench a load takes about 2
// shared-memory passes, on uniformly random buckets about 3.1 (counted from
// the bucket maps by chip_smoke.py's bank_passes), so the floor of this form
// is about 1.1 ms and 1.7 ms. Shared-memory passes, not the count of
// instructions, set the time: with every weight unpack removed the kernel is
// no faster on the hash's buckets.
//
// Design.
//  - The bank lives in shared memory. A block keeps several phases' rows
//    resident (nbucket x 121 bf16 each, 52.7 KB at 216 buckets): all four at
//    x2 (211 KB of the 227 KB a block may take, opted in to with
//    cudaFuncSetAttribute), three of nine at x3, two of sixteen at x4. One
//    persistent block per SM: the blocks of one set of phases share out the
//    tiles of all images, so the bank is read from L2 once per block and a
//    tile's planes are staged once for all resident phases.
//  - Row stride 61 words (122 bf16, one pad tap): odd, so tap q of rows that
//    differ mod 32 lies in different banks, and equal rows broadcast.
//  - A 16 x 64 pixel tile of all s*s planes plus the filter's reach is staged
//    as bf16 (rounded once per element), 4 columns of left padding so that a
//    thread's columns start on an 8-byte boundary. The next tile's planes
//    are loaded into registers before the current tile is computed and
//    stored to shared memory after it, so their latency hides behind the
//    taps.
//  - 256 threads per resident phase; a thread computes 4 horizontally
//    adjacent pixels of its phase. Per tap row it reads each tap plane's
//    8-12 tile values once with 8-byte loads and unpacks them once; the 11
//    taps x 4 pixels then run from registers. The column phase is a template
//    constant, so which register a tap reads is fixed at compile time; the
//    row phase is not needed at compile time. Each pixel keeps its own
//    bucket and so its own filter row: one 4-byte shared-memory load per two
//    weights.
//  - Bytes at the interface are unchanged: f32 planes and int32 buckets in,
//    f32 out (16-byte loads and stores; w2p must be a multiple of 4, as
//    every plane geometry's is).
//
// Measured at the bench shape on an NVIDIA H100 80GB HBM3 at 700 W
// (chip_smoke.py): 1.55 ms on the hash's own buckets, 2.09 ms on uniformly
// random buckets; the earlier form, which read each pixel's row from device
// memory through L1, took 4.19 ms. PERF.md section 6 has the forms tried.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kFL = 11;               // filter length
constexpr int kM = kFL / 2;           // filter reach in full-res pixels
constexpr int kTaps = kFL * kFL;
constexpr int kRowWords = (kTaps + 2) / 2;  // 61: 121 taps and one pad, odd
constexpr int kGroup = 256;  // threads that compute one phase of a tile
constexpr int kTileH = 16;   // plane rows per tile
constexpr int kTileW = 64;   // plane columns per tile
constexpr int kPx = 4;       // adjacent pixels per thread
constexpr int kPadL = 4;     // tile columns left of the first pixel
constexpr int kEW = kTileW + 2 * kPadL;  // staged columns (reach <= 3 < kPadL)
constexpr int kChunks = 3;   // 4-column chunks a thread's taps can touch
static_assert(kTileH * kTileW == kGroup * kPx, "one tile pass per block");

__device__ __forceinline__ float bf16_lo(unsigned int word) {
  return __uint_as_float(word << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned int word) {
  return __uint_as_float(word & 0xffff0000u);
}

// One thread, 4 adjacent pixels of phase (py, PX) at tile row ly, tile
// columns 4*lx .. 4*lx + 3. S, PX compile-time: every tap's register is fixed.
template <int S, int PX>
__device__ __forceinline__ void apply_pixels(
    const unsigned int* __restrict__ bank_s,
    const unsigned short* __restrict__ tile, int py, int ly, int lx,
    const int (&rowoff)[kPx], float (&acc)[kPx]) {
  constexpr int kReach = (kM + S - 1) / S;
  constexpr int kEH = kTileH + 2 * kReach;
  unsigned int wword[kPx];
#pragma unroll
  for (int ti = 0; ti < kFL; ++ti) {
    // tap row ti reads row-phase plane a at tile row y (shift keeps / and % >= 0)
    const int vr = py - kM + ti + 8 * S;
    const int a = vr % S;
    const int y = ly + kReach + vr / S - 8;
    // the tile values of this row the 4 pixels touch, per column-phase plane
    float tv[S][4 * kChunks];
#pragma unroll
    for (int b = 0; b < S; ++b) {
      int c_lo = 99, c_hi = -99;  // column offsets of the taps on plane b
#pragma unroll
      for (int tj = 0; tj < kFL; ++tj) {
        const int vc = PX - kM + tj + 8 * S;
        if (vc % S == b) {
          c_lo = min(c_lo, vc / S - 8);
          c_hi = max(c_hi, vc / S - 8);
        }
      }
      const uint2* row = reinterpret_cast<const uint2*>(
          tile + ((a * S + b) * kEH + y) * kEW + kPx * lx);
#pragma unroll
      for (int ch = 0; ch < kChunks; ++ch) {
        if (ch >= (kPadL + c_lo) / 4 && ch <= (kPadL + c_hi + kPx - 1) / 4) {
          const uint2 u = row[ch];
          tv[b][4 * ch + 0] = bf16_lo(u.x);
          tv[b][4 * ch + 1] = bf16_hi(u.x);
          tv[b][4 * ch + 2] = bf16_lo(u.y);
          tv[b][4 * ch + 3] = bf16_hi(u.y);
        }
      }
    }
#pragma unroll
    for (int tj = 0; tj < kFL; ++tj) {
      const int q = ti * kFL + tj;  // taps summed in order q = 0 .. kTaps-1
      const int vc = PX - kM + tj + 8 * S;
      const int b = vc % S;
      const int col = kPadL + vc / S - 8;
#pragma unroll
      for (int k = 0; k < kPx; ++k) {
        if ((q & 1) == 0) wword[k] = bank_s[rowoff[k] + (q >> 1)];
        const float wt = (q & 1) ? bf16_hi(wword[k]) : bf16_lo(wword[k]);
        acc[k] = fmaf(tv[b][col + k], wt, acc[k]);
      }
    }
  }
}

// Runs the body compiled for column phase px (uniform over a warp).
template <int S, int PX = 0>
__device__ __forceinline__ void apply_phase(
    int px, const unsigned int* __restrict__ bank_s,
    const unsigned short* __restrict__ tile, int py, int ly, int lx,
    const int (&rowoff)[kPx], float (&acc)[kPx]) {
  if (px == PX) {
    apply_pixels<S, PX>(bank_s, tile, py, ly, lx, rowoff, acc);
  } else if constexpr (PX + 1 < S) {
    apply_phase<S, PX + 1>(px, bank_s, tile, py, ly, lx, rowoff, acc);
  }
}

// Phases a block keeps resident: all four at x2, three of nine at x3, two of
// sixteen at x4 (the tile holds s*s planes, so x4 leaves room for two banks).
template <int S>
struct Resident {
  static constexpr int kPhases = S == 2 ? 4 : (S == 3 ? 3 : 2);
};

template <int S>
__global__ void __launch_bounds__(Resident<S>::kPhases * kGroup, 1)
raisr_apply_kernel(
    const float* __restrict__ planes, const int* __restrict__ buckets,
    const unsigned int* __restrict__ bank, float* __restrict__ out, int nimg,
    int nb, int hp, int rows, int wq, int h2p, int w2p, int nbucket,
    int tiles_y, int tiles_x, int nstreams) {
  constexpr int kSS = S * S;
  constexpr int kP = Resident<S>::kPhases;
  constexpr int kThreads = kP * kGroup;
  constexpr int kSets = kSS / kP;  // blocks that together cover the phases
  constexpr int kReach = (kM + S - 1) / S;
  constexpr int kEH = kTileH + 2 * kReach;
  constexpr int kTileWords = kSS * kEH * (kEW / 2);
  constexpr int kStage = (kTileWords + kThreads - 1) / kThreads;
  extern __shared__ uint4 smem[];
  unsigned int* bank_s = reinterpret_cast<unsigned int*>(smem);
  const int phase_words = nbucket * kRowWords;
  const int bank_words = (kP * phase_words + 3) / 4 * 4;
  unsigned int* tile_w = bank_s + bank_words;
  const unsigned short* tile = reinterpret_cast<const unsigned short*>(tile_w);

  const int set = blockIdx.x % kSets;
  {
    // the block's kP phases are adjacent in the bank
    const unsigned int* src = bank + static_cast<size_t>(set) * kP * phase_words;
    for (int e = threadIdx.x; e < kP * phase_words; e += kThreads)
      bank_s[e] = src[e];
  }
  const int group = threadIdx.x / kGroup;  // warp-uniform: one phase per group
  const int t = set * kP + group;
  const int py = t / S;
  const int px = t - py * S;
  const unsigned int* rows_s = bank_s + group * phase_words;
  const int lane = threadIdx.x % kGroup;
  const int lx = lane % (kTileW / kPx);
  const int ly = lane / (kTileW / kPx);
  const size_t plane_px = static_cast<size_t>(h2p) * w2p;
  const int ntiles = nimg * tiles_y * tiles_x;

  // a tile's planes travel through registers: loaded before the previous
  // tile is computed, rounded and stored to shared memory after it
  float pf[kStage][2];
  auto fetch = [&](int tile_id) {
    const int tx = tile_id % tiles_x;
    const int rest = tile_id / tiles_x;
    const int i0 = (rest % tiles_y) * kTileH;
    const int j0 = tx * kTileW;
    const float* img =
        planes + static_cast<size_t>(rest / tiles_y) * kSS * rows * wq;
#pragma unroll
    for (int it = 0; it < kStage; ++it) {
      const int e = threadIdx.x + it * kThreads;
      const int p = e / (kEH * (kEW / 2));
      const int rem = e - p * (kEH * (kEW / 2));
      const int y = rem / (kEW / 2);
      const int r = i0 + hp - kReach + y;
      const int c = j0 + hp - kPadL + 2 * (rem - y * (kEW / 2));
      float v0 = 0.0f, v1 = 0.0f;
      if (e < kTileWords && r < rows) {
        const float* src = img + (static_cast<size_t>(p) * rows + r) * wq;
        if (c >= 0 && c < wq) v0 = src[c];
        if (c + 1 >= 0 && c + 1 < wq) v1 = src[c + 1];
      }
      pf[it][0] = v0;
      pf[it][1] = v1;
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int it = 0; it < kStage; ++it) {
      const int e = threadIdx.x + it * kThreads;
      const __nv_bfloat162 pk = __floats2bfloat162_rn(pf[it][0], pf[it][1]);
      if (e < kTileWords)  // .x is the low half: the even column
        tile_w[e] = *reinterpret_cast<const unsigned int*>(&pk);
    }
  };

  int tile_id = blockIdx.x / kSets;
  if (tile_id < ntiles) {
    fetch(tile_id);
    stage();
  }
  for (; tile_id < ntiles; tile_id += nstreams) {
    __syncthreads();  // the tile (and, the first time, the bank) is in place
    const int next = tile_id + nstreams;
    if (next < ntiles) fetch(next);

    const int tx = tile_id % tiles_x;
    const int rest = tile_id / tiles_x;
    const int n = rest / tiles_y;
    const int gi = (rest % tiles_y) * kTileH + ly;
    const int gj = tx * kTileW + kPx * lx;
    if (gi < h2p && gj < w2p) {
      const size_t o = static_cast<size_t>(t) * plane_px +
                       static_cast<size_t>(gi) * w2p + gj;
      const int* bmap = buckets + static_cast<size_t>(n % nb) * kSS * plane_px + o;
      float* optr = out + static_cast<size_t>(n) * kSS * plane_px + o;
      // w2p is a multiple of 4: the thread's 4 pixels are all inside
      const int4 b4 = *reinterpret_cast<const int4*>(bmap);
      int bk[kPx] = {b4.x, b4.y, b4.z, b4.w};
      int rowoff[kPx];
      float acc[kPx];
#pragma unroll
      for (int k = 0; k < kPx; ++k) {
        const bool ok = bk[k] >= 0 && bk[k] < nbucket;
        rowoff[k] = ok ? bk[k] * kRowWords : 0;
        bk[k] = ok;
        acc[k] = 0.0f;
      }
      apply_phase<S>(px, rows_s, tile, py, ly, lx, rowoff, acc);
#pragma unroll
      for (int k = 0; k < kPx; ++k) acc[k] = bk[k] ? acc[k] : 0.0f;
      *reinterpret_cast<float4*>(optr) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    }
    __syncthreads();  // every reader of the tile is done
    if (next < ntiles) stage();
  }
}

template <int S>
cudaError_t launch(const float* planes, const int* buckets, const void* bank,
                   float* out, int nimg, int nb, int hp, int rows, int wq,
                   int h2p, int w2p, int nbucket, cudaStream_t stream) {
  constexpr int kP = Resident<S>::kPhases;
  constexpr int kSets = S * S / kP;
  constexpr int kReach = (kM + S - 1) / S;
  constexpr int kEH = kTileH + 2 * kReach;
  static_assert(S * S % kP == 0, "the sets of resident phases cover all phases");
  if (hp < kReach) return cudaErrorInvalidValue;
  const size_t smem =
      sizeof(unsigned int) * ((kP * nbucket * kRowWords + 3) / 4 * 4) +
      sizeof(unsigned short) * S * S * kEH * kEW;
  cudaError_t err = cudaFuncSetAttribute(
      raisr_apply_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int tiles_y = (h2p + kTileH - 1) / kTileH;
  const int tiles_x = (w2p + kTileW - 1) / kTileW;
  const long long ntiles = static_cast<long long>(nimg) * tiles_y * tiles_x;
  if (ntiles > 2147483647LL) return cudaErrorInvalidValue;
  // persistent blocks, one per SM: per set of phases, as many as fill the
  // card or as there are tiles
  long long nstreams = sms / kSets;
  if (nstreams < 1) nstreams = 1;
  if (nstreams > ntiles) nstreams = ntiles;
  raisr_apply_kernel<S><<<static_cast<unsigned int>(nstreams * kSets), kP * kGroup, smem, stream>>>(
      planes, buckets, static_cast<const unsigned int*>(bank), out, nimg, nb,
      hp, rows, wq, h2p, w2p, nbucket, tiles_y, tiles_x,
      static_cast<int>(nstreams));
  return cudaGetLastError();
}

}  // namespace

// bank: per phase and bucket, fl*fl bf16 taps and one zero pad tap
// (row_stride 122 bf16 = 61 words), 4-byte aligned. Built for fl = 11 at
// scales 2, 3 and 4 (every bank the repository ships) and plane widths w2p
// that are multiples of 4; anything else is refused.
extern "C" int ocvk_raisr_apply(const float* planes, const int* buckets,
                                const void* bank, float* out, int nimg,
                                int nb, int s, int fl, int hp, int rows,
                                int wq, int h2p, int w2p, int nbucket,
                                int row_stride, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (fl != kFL || row_stride != 2 * kRowWords || w2p % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  switch (s) {
    case 2:
      err = launch<2>(planes, buckets, bank, out, nimg, nb, hp, rows, wq, h2p,
                      w2p, nbucket, st);
      break;
    case 3:
      err = launch<3>(planes, buckets, bank, out, nimg, nb, hp, rows, wq, h2p,
                      w2p, nbucket, st);
      break;
    case 4:
      err = launch<4>(planes, buckets, bank, out, nimg, nb, hp, rows, wq, h2p,
                      w2p, nbucket, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
