// RAISR per-pixel filter select and apply in parity-plane space, generic
// form: any scale and filter length, read at run time, with the bank
// resident in shared memory.
//
// Replaces, with raisr_apply.cu and raisr_apply_generic_l2.cu, the TPU
// kernel oclcomputervision_tpu/ops/pallas/raisr_pallas.py, _apply_phase
// (body _make_kernel), which is written for any filter_len and scale.
// raisr_apply.cu is compiled for filter length 11 at scales 2-4;
// kernels/raisr.apply_form sends every other config here when one phase's
// bank and a tile fit a block's shared memory (generic_apply_phases), and to
// raisr_apply_generic_l2.cu otherwise. The launches count as
// raisr_apply_generic.
//
// Output pixel (y, x) of phase t = (py, px) of image n, as raisr_apply.cu:
//   out = sum_q bf16(tap_q) * bf16(bank[t][bucket][q]),  q = ti*fl + tj,
// tap_q from plane ((py - m + ti) mod s, (px - m + tj) mod s) at plane
// (y + hp + floor((py - m + ti)/s), x + hp + floor((px - m + tj)/s)),
// bucket = buckets[n % B][t][y][x]; q summed in order with one fmaf per tap
// (a bf16 x bf16 product is exact in f32), so it equals the plain version
// bit for bit. A bucket outside [0, nbucket) gives 0.
//
// What bounds it on the H100: as raisr_apply.cu, the shared-memory passes
// of the filter-row loads (each pixel reads its own bucket's row, so the 32
// lanes of a warp read 32 rows), then the tap loads, which here cannot come
// from registers fixed at compile time. The one-thread-per-pixel form
// (raisr_apply_generic_l2.cu) reads every tap and weight through L1:
// 0.46 G taps/ms against raisr_apply.cu's 5.2.
//
// Design, raisr_apply.cu's carried over to a run-time scale and filter
// length:
//  - The bank lives in shared memory: `phases` resident phases' rows
//    (kernels/raisr.generic_apply_phases picks the most that fit beside the
//    tile, at most 4), opted in to above 48 KB with cudaFuncSetAttribute.
//    Persistent blocks, as many per SM as fit: the blocks of one set of
//    phases share out the tiles of all images. One instance, bound to the
//    1024 threads of 4 resident phases (64 registers a thread).
//  - Row stride an odd word count, (fl*fl + 1) / 2 for odd fl, one pad word
//    more for even fl, so that tap q of rows that differ mod 32 lies in
//    different banks, and equal rows broadcast.
//  - A 16 x 64 pixel tile of all s*s planes plus the filter's reach is
//    staged as bf16 (rounded once per element) once for all resident
//    phases, with an odd word pitch per tile row so that the two tile rows
//    a warp reads hit different banks. The next tile's first 8 words per
//    thread are loaded into registers before the current tile is computed
//    (all of the tile at the bench configs but x5, whose 25 planes are 21
//    words a thread).
//  - Each phase's tap table (plane, row offset, column offset), built once
//    on the host (kernels/raisr.generic_tap_table), becomes per tap the
//    word offset into the tile from a thread's first word and the funnel
//    shift (0 or 16 bits) of its column parity, staged once per block: no
//    division, and no address arithmetic beyond one add, per tap.
//  - A thread computes 4 horizontally adjacent pixels: per tap it reads the
//    4 tile values with three 4-byte loads and two funnel shifts (the shift
//    0 or 16 bits by the parity of the tap's column offset, with no branch),
//    and each pixel's weight from its own row, one 4-byte load per two taps.
//  - Any plane width: rows whose width is a multiple of 4 load buckets and
//    store outputs 16 bytes at a time, others one pixel at a time with the
//    tail masked.
// What holds it now: issued instructions, about 25 a tap for 4 pixels (the
// tap loads and their unpacking are half of them, where raisr_apply.cu
// reads its taps from registers fixed at compile time). Per-tap branches
// cost more than loads: the form that loaded two words on even offsets
// and branched was 18 % slower, and a sliding window of tap values per
// column phase (one 2-byte load per tap, the scale a template constant)
// 26 % slower; the table of word offsets and shifts saved 5 % over one of
// element offsets. At x5 the tile's 25 planes overflow the prefetch
// registers, and loading the rest after the taps takes about a quarter of
// the time; loading it in batches of 8 to 24 words a thread was no faster
// (at 768 threads the larger batches spill).
// One instance bound to 1024 threads costs 2.7 % at filter length 13
// against an instance per resident-phase count (whose bound let 2 phases
// take 128 registers a thread), and nothing at x5.
// Measured at the bench geometry (NVIDIA H100 80GB HBM3, 700 W,
// kernels/forms.py, 16 x 1024^2): filter length 13 at x2 4.2281 ms, x5
// 30.4729 ms; the one-thread-per-pixel form (raisr_apply_generic_l2.cu)
// 22.9982 and 106.0459 ms (PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 256;    // threads that compute one phase of a tile
constexpr int kMaxPhases = 4;  // resident phases: at most 1024 threads
constexpr int kTileH = 16;     // plane rows per tile
constexpr int kTileW = 64;     // plane columns per tile
constexpr int kPx = 4;         // adjacent pixels per thread
constexpr int kPrefetch = 8;   // tile words per thread loaded ahead into registers
constexpr int kSmemLimit = 232448;
static_assert(kTileH * kTileW == kGroup * kPx, "one tile pass per phase");

__device__ __forceinline__ float bf16_lo(unsigned int word) {
  return __uint_as_float(word << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned int word) {
  return __uint_as_float(word & 0xffff0000u);
}

// The staged tile of s*s planes: reach R plane rows and columns around the
// 16 x 64 pixels, padL >= R columns (even) on each side, a row of
// 32 + padL words padded to an odd pitch. kernels/raisr.generic_apply_smem
// computes the same sizes in Python (to choose the form on any device);
// ocvk_raisr_apply_generic_smem exports this file's, which chip_smoke.py
// holds equal to it.
struct Tile {
  int reach, padl, half, pitch, eh, plane_words, words;
};

__host__ __device__ inline Tile tile_geometry(int s, int fl) {
  Tile g;
  g.reach = (fl / 2 + s - 1) / s;
  g.padl = (g.reach + 1) / 2 * 2;
  g.half = kTileW / 2 + g.padl;  // staged words per tile row
  g.pitch = g.half % 2 == 0 ? g.half + 1 : g.half + 2;
  g.eh = kTileH + 2 * g.reach;
  g.plane_words = g.eh * g.pitch;
  g.words = s * s * g.plane_words;
  return g;
}

__host__ __device__ inline int row_words(int fl) {
  const int w = (fl * fl + 1) / 2;
  return w % 2 ? w : w + 1;
}

__host__ __device__ inline int tap_stride(int fl) { return (fl * fl + 1) / 2 * 4; }

__host__ __device__ inline long long smem_bytes(int s, int fl, int nbucket, int phases) {
  const long long bank = (static_cast<long long>(phases) * nbucket * row_words(fl) + 3) / 4 * 4;
  return 4 * (bank + static_cast<long long>(phases) * tap_stride(fl) + tile_geometry(s, fl).words);
}

// Walks the staged words e = first, first + step, ... of a tile as (plane,
// tile row, word column) without a division per word.
struct Walker {
  int p, y, cw;
  __device__ void start(int e, const Tile& g) {
    const int row = e / g.half;
    cw = e - row * g.half;
    p = row / g.eh;
    y = row - p * g.eh;
  }
  __device__ void advance(int drow, int dcol, const Tile& g) {
    cw += dcol;
    y += drow;
    if (cw >= g.half) {
      cw -= g.half;
      ++y;
    }
    while (y >= g.eh) {
      y -= g.eh;
      ++p;
    }
  }
};

__global__ void __launch_bounds__(kMaxPhases * kGroup, 1) raisr_apply_generic_kernel(
    const float* __restrict__ planes, const int* __restrict__ buckets,
    const unsigned int* __restrict__ bank, const int* __restrict__ taps,
    float* __restrict__ out, int nimg, int nb, int s, int fl, int hp, int rows, int wq,
    int h2p, int w2p, int nbucket, int phases, int nsets, int tiles_y, int tiles_x,
    int nstreams) {
  extern __shared__ uint4 smem[];
  const int ss = s * s;
  const int ntap = fl * fl;
  const int rw = row_words(fl);
  const int tstride = tap_stride(fl);
  const Tile g = tile_geometry(s, fl);
  const int nthreads = phases * kGroup;
  const int phase_words = nbucket * rw;
  unsigned int* bank_s = reinterpret_cast<unsigned int*>(smem);
  int* tap_s = reinterpret_cast<int*>(bank_s + (phases * phase_words + 3) / 4 * 4);
  unsigned int* tile_w = reinterpret_cast<unsigned int*>(tap_s + phases * tstride);

  const int set = blockIdx.x % nsets;
  const int t0 = set * phases;
  const int nph = min(phases, ss - t0);  // the last set may hold fewer phases
  {
    // the block's phases are adjacent in the bank
    const unsigned int* src = bank + static_cast<size_t>(t0) * phase_words;
    for (int e = threadIdx.x; e < nph * phase_words; e += nthreads) bank_s[e] = src[e];
    // taps [t][q] = (plane, row offset, column offset) -> element offset
    // into the tile from a thread's pixel 0
    for (int e = threadIdx.x; e < nph * ntap; e += nthreads) {
      const int ph = e / ntap;
      const int q = e - ph * ntap;
      const int* tq = taps + (static_cast<size_t>(t0 + ph) * ntap + q) * 3;
      const int off = 2 * (tq[0] * g.plane_words + tq[1] * g.pitch) + tq[2];
      tap_s[ph * tstride + 2 * q] = off >> 1;
      tap_s[ph * tstride + 2 * q + 1] = (off & 1) * 16;
    }
  }
  const int group = threadIdx.x / kGroup;  // warp-uniform: one phase per group
  const bool computes = group < nph;
  const int t = t0 + group;
  const unsigned int* rows_s = bank_s + group * phase_words;
  const int* offs = tap_s + group * tstride;
  const int lane = threadIdx.x % kGroup;
  const int lx = lane % (kTileW / kPx);
  const int ly = lane / (kTileW / kPx);
  // element index of pixel 0 at tap offset (0, 0) in plane 0: even, so a
  // tap's parity is its column offset's
  const int base = 2 * (ly + g.reach) * g.pitch + g.padl + kPx * lx;
  const size_t plane_px = static_cast<size_t>(h2p) * w2p;
  const int ntiles = nimg * tiles_y * tiles_x;
  const bool vec = w2p % 4 == 0;

  const int stage_words = ss * g.eh * g.half;
  const int drow = nthreads / g.half;
  const int dcol = nthreads - drow * g.half;
  const size_t plane = static_cast<size_t>(rows) * wq;
  // the first kPrefetch words per thread of a tile travel through registers:
  // loaded before the previous tile is computed, stored after it
  float pf[kPrefetch][2];
  auto load_word = [&](const float* img, int i0, int j0, const Walker& w, float& v0, float& v1) {
    const int r = i0 + hp - g.reach + w.y;
    const int c = j0 + hp - g.padl + 2 * w.cw;
    v0 = 0.0f;
    v1 = 0.0f;
    if (r < rows) {
      const float* src = img + w.p * plane + static_cast<size_t>(r) * wq;
      if (c >= 0 && c < wq) v0 = __ldg(src + c);
      if (c + 1 >= 0 && c + 1 < wq) v1 = __ldg(src + c + 1);
    }
  };
  auto tile_origin = [&](int tile_id, const float*& img, int& i0, int& j0) {
    const int tx = tile_id % tiles_x;
    const int rest = tile_id / tiles_x;
    i0 = (rest % tiles_y) * kTileH;
    j0 = tx * kTileW;
    img = planes + static_cast<size_t>(rest / tiles_y) * ss * plane;
  };
  auto fetch = [&](int tile_id) {
    const float* img;
    int i0, j0;
    tile_origin(tile_id, img, i0, j0);
    Walker w;
    w.start(threadIdx.x, g);
#pragma unroll
    for (int it = 0; it < kPrefetch; ++it) {
      if (threadIdx.x + it * nthreads < stage_words) load_word(img, i0, j0, w, pf[it][0], pf[it][1]);
      w.advance(drow, dcol, g);
    }
  };
  auto put = [&](const Walker& w, float v0, float v1) {
    const __nv_bfloat162 pk = __floats2bfloat162_rn(v0, v1);  // .x, the even column, is the low half
    tile_w[w.p * g.plane_words + w.y * g.pitch + w.cw] = *reinterpret_cast<const unsigned int*>(&pk);
  };
  auto stage = [&](int tile_id) {
    Walker w;
    w.start(threadIdx.x, g);
#pragma unroll
    for (int it = 0; it < kPrefetch; ++it) {
      if (threadIdx.x + it * nthreads < stage_words) put(w, pf[it][0], pf[it][1]);
      w.advance(drow, dcol, g);
    }
    // what did not fit the registers, loaded and stored now
    const int rest = threadIdx.x + kPrefetch * nthreads;
    if (rest < stage_words) {
      const float* img;
      int i0, j0;
      tile_origin(tile_id, img, i0, j0);
      w.start(rest, g);
      for (int e = rest; e < stage_words; e += nthreads) {
        float v0, v1;
        load_word(img, i0, j0, w, v0, v1);
        put(w, v0, v1);
        w.advance(drow, dcol, g);
      }
    }
  };

  int tile_id = blockIdx.x / nsets;
  if (tile_id < ntiles) {
    fetch(tile_id);
    stage(tile_id);
  }
  for (; tile_id < ntiles; tile_id += nstreams) {
    __syncthreads();  // the tile (and, the first time, the bank and taps) is in place
    const int next = tile_id + nstreams;
    if (next < ntiles) fetch(next);

    const int tx = tile_id % tiles_x;
    const int rest = tile_id / tiles_x;
    const int n = rest / tiles_y;
    const int gi = (rest % tiles_y) * kTileH + ly;
    const int gj = tx * kTileW + kPx * lx;
    if (computes && gi < h2p && gj < w2p) {
      const size_t o = static_cast<size_t>(t) * plane_px + static_cast<size_t>(gi) * w2p + gj;
      const int* bmap = buckets + static_cast<size_t>(n % nb) * ss * plane_px + o;
      float* optr = out + static_cast<size_t>(n) * ss * plane_px + o;
      int bk[kPx];
      if (vec) {
        const int4 b4 = *reinterpret_cast<const int4*>(bmap);
        bk[0] = b4.x;
        bk[1] = b4.y;
        bk[2] = b4.z;
        bk[3] = b4.w;
      } else {
#pragma unroll
        for (int k = 0; k < kPx; ++k) bk[k] = gj + k < w2p ? bmap[k] : -1;
      }
      const unsigned int* wrow[kPx];
      float acc[kPx];
#pragma unroll
      for (int k = 0; k < kPx; ++k) {
        const bool ok = bk[k] >= 0 && bk[k] < nbucket;
        wrow[k] = rows_s + (ok ? bk[k] * rw : 0);
        bk[k] = ok;
        acc[k] = 0.0f;
      }
      const unsigned int* tbase = tile_w + (base >> 1);
      // taps in order q = 0 .. fl*fl - 1, two per weight word
      for (int q = 0; q < ntap; q += 2) {
        unsigned int ww[kPx];
#pragma unroll
        for (int k = 0; k < kPx; ++k) ww[k] = wrow[k][q >> 1];
        const int4 off = *reinterpret_cast<const int4*>(offs + 2 * q);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (h == 1 && q + 1 >= ntap) break;
          const unsigned int* tw = tbase + (h ? off.z : off.x);
          const unsigned int sh = h ? off.w : off.y;
          const unsigned int a = tw[0], b = tw[1], c = tw[2];
          const unsigned int u0 = __funnelshift_r(a, b, sh), u1 = __funnelshift_r(b, c, sh);
          const float v[kPx] = {bf16_lo(u0), bf16_hi(u0), bf16_lo(u1), bf16_hi(u1)};
#pragma unroll
          for (int k = 0; k < kPx; ++k)
            acc[k] = fmaf(v[k], h ? bf16_hi(ww[k]) : bf16_lo(ww[k]), acc[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < kPx; ++k) acc[k] = bk[k] ? acc[k] : 0.0f;
      if (vec) {
        *reinterpret_cast<float4*>(optr) = make_float4(acc[0], acc[1], acc[2], acc[3]);
      } else {
#pragma unroll
        for (int k = 0; k < kPx; ++k)
          if (gj + k < w2p) optr[k] = acc[k];
      }
    }
    __syncthreads();  // every reader of the tile is done
    if (next < ntiles) stage(next);
  }
}

}  // namespace

// bank: per phase and bucket, fl*fl bf16 taps and zero padding, row_words
// 4-byte words a row (kernels/raisr.generic_row_words: odd), 4-byte
// aligned. taps: int32 [s*s, fl*fl, 3], per phase and tap the plane, row
// offset and column offset (kernels/raisr.generic_tap_table). phases: the
// resident phases a block holds (kernels/raisr.generic_apply_phases), 1-4,
// whose banks, taps and tile must fit 232,448 bytes of shared memory.
// Planes [nimg, s*s, rows, wq] with origin (hp, hp), hp >= ceil((fl/2)/s),
// rows >= h2p + 2 hp, wq >= w2p + 2 hp; buckets [nb, s*s, h2p, w2p], nimg a
// multiple of nb; any w2p.
extern "C" int ocvk_raisr_apply_generic(const float* planes, const int* buckets,
                                        const void* bank, const int* taps, float* out,
                                        int nimg, int nb, int s, int fl, int hp, int rows,
                                        int wq, int h2p, int w2p, int nbucket, int rwords,
                                        int phases, void* stream) {
  if (s < 1 || fl < 1 || nbucket < 1 || rwords != row_words(fl) || phases < 1 ||
      phases > kMaxPhases || phases > s * s || nb < 1 || nimg % nb != 0 ||
      hp < tile_geometry(s, fl).reach || (reinterpret_cast<uintptr_t>(bank) & 3u) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long smem = smem_bytes(s, fl, nbucket, phases);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_y = (h2p + kTileH - 1) / kTileH;
  const int tiles_x = (w2p + kTileW - 1) / kTileW;
  const long long ntiles = static_cast<long long>(nimg) * tiles_y * tiles_x;
  if (ntiles > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = raisr_apply_generic_kernel;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = phases * kGroup;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                      static_cast<size_t>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int nsets = (s * s + phases - 1) / phases;
  // persistent blocks: per set of phases, as many as fill the card or as
  // there are tiles
  long long nstreams = static_cast<long long>(sms) * per_sm / nsets;
  if (nstreams < 1) nstreams = 1;
  if (nstreams > ntiles) nstreams = ntiles;
  kernel<<<static_cast<unsigned int>(nstreams * nsets), threads, static_cast<size_t>(smem),
           static_cast<cudaStream_t>(stream)>>>(
      planes, buckets, static_cast<const unsigned int*>(bank), taps, out, nimg, nb, s, fl, hp,
      rows, wq, h2p, w2p, nbucket, phases, nsets, tiles_y, tiles_x, static_cast<int>(nstreams));
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of a launch with `phases` resident phases, as the
// entry point above computes it (for the check against
// kernels/raisr.generic_apply_smem).
extern "C" long long ocvk_raisr_apply_generic_smem(int s, int fl, int nbucket, int phases) {
  return smem_bytes(s, fl, nbucket, phases);
}
