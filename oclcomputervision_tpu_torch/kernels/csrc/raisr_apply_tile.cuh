// What the two run-time-config RAISR apply forms share (raisr_apply_generic.cu,
// raisr_apply_split.cu): the staged bf16 tile and its geometry, the staging
// of a tile through prefetch registers, and the tap loop over 4 adjacent
// pixels.
//
// A group of 256 threads computes one phase of a 16 x 64 pixel tile, 4
// horizontally adjacent pixels a thread. The tile holds `nplanes` planes
// (all s*s of an image, or the ones a split's taps read) plus the filter's
// reach R on each side, as bf16 (rounded once per element), padL >= R
// columns (even) on each side, a row of 32 + padL words padded to an odd
// pitch so that the two tile rows a warp reads hit different banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace ocvk_apply {

constexpr int kGroup = 256;  // threads that compute one phase of a tile
constexpr int kTileH = 16;   // plane rows per tile
constexpr int kTileW = 64;   // plane columns per tile
constexpr int kPx = 4;       // adjacent pixels per thread
constexpr int kSmemLimit = 232448;
static_assert(kTileH * kTileW == kGroup * kPx, "one tile pass per phase");

__device__ __forceinline__ float bf16_lo(unsigned int word) {
  return __uint_as_float(word << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned int word) {
  return __uint_as_float(word & 0xffff0000u);
}

// 32-bit words per bank row of `taps` bf16 weights: (taps + 1) / 2, one
// more if that is even, so that one tap of rows that differ mod 32 lies in
// different banks and equal rows broadcast.
__host__ __device__ inline int odd_words(int taps) {
  const int w = (taps + 1) / 2;
  return w % 2 ? w : w + 1;
}

struct Tile {
  int reach, padl, half, pitch, eh, plane_words, words;
};

__host__ __device__ inline Tile tile_geometry(int s, int fl, int nplanes) {
  Tile g;
  g.reach = (fl / 2 + s - 1) / s;
  g.padl = (g.reach + 1) / 2 * 2;
  g.half = kTileW / 2 + g.padl;  // staged words per tile row
  g.pitch = g.half % 2 == 0 ? g.half + 1 : g.half + 2;
  g.eh = kTileH + 2 * g.reach;
  g.plane_words = g.eh * g.pitch;
  g.words = nplanes * g.plane_words;
  return g;
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

// Stages tiles of `nplanes` planes of an image's s*s into shared memory:
// fetch() loads the first kPrefetch words per thread of a tile into
// registers (before the previous tile is computed), stage() stores them
// (after it) and loads and stores the rest. Staged plane p is the image's
// plane plist[p] with kPlaneList, plane p otherwise.
template <int kPrefetch, bool kPlaneList>
struct Stager {
  const float* planes;
  const int* plist;
  unsigned int* tile_w;
  Tile g;
  size_t plane;  // floats per plane
  int ss, hp, rows, wq, tiles_y, tiles_x, nthreads, stage_words, drow, dcol;
  float pf[kPrefetch][2];

  __device__ Stager(const float* planes_, const int* plist_, unsigned int* tile_w_, const Tile& g_,
                    int s, int hp_, int rows_, int wq_, int tiles_y_, int tiles_x_,
                    int nthreads_)
      : planes(planes_), plist(plist_), tile_w(tile_w_), g(g_),
        plane(static_cast<size_t>(rows_) * wq_), ss(s * s), hp(hp_), rows(rows_), wq(wq_),
        tiles_y(tiles_y_), tiles_x(tiles_x_), nthreads(nthreads_), stage_words(0),
        drow(nthreads_ / g_.half), dcol(nthreads_ - nthreads_ / g_.half * g_.half) {}

  __device__ void set_planes(int nplanes) { stage_words = nplanes * g.eh * g.half; }

  __device__ const float* origin(int tile_id, int& i0, int& j0) const {
    const int tx = tile_id % tiles_x;
    const int rest = tile_id / tiles_x;
    i0 = (rest % tiles_y) * kTileH;
    j0 = tx * kTileW;
    return planes + static_cast<size_t>(rest / tiles_y) * ss * plane;
  }

  __device__ void load(const float* img, int i0, int j0, const Walker& w, float& v0,
                       float& v1) const {
    const int r = i0 + hp - g.reach + w.y;
    const int c = j0 + hp - g.padl + 2 * w.cw;
    v0 = 0.0f;
    v1 = 0.0f;
    if (r < rows) {
      const int p = kPlaneList ? plist[w.p] : w.p;
      const float* src = img + p * plane + static_cast<size_t>(r) * wq;
      if (c >= 0 && c < wq) v0 = __ldg(src + c);
      if (c + 1 >= 0 && c + 1 < wq) v1 = __ldg(src + c + 1);
    }
  }

  __device__ void put(const Walker& w, float v0, float v1) {
    const __nv_bfloat162 pk = __floats2bfloat162_rn(v0, v1);  // .x, the even column, is the low half
    tile_w[w.p * g.plane_words + w.y * g.pitch + w.cw] = *reinterpret_cast<const unsigned int*>(&pk);
  }

  __device__ void fetch(int tile_id) {
    int i0, j0;
    const float* img = origin(tile_id, i0, j0);
    Walker w;
    w.start(threadIdx.x, g);
#pragma unroll
    for (int it = 0; it < kPrefetch; ++it) {
      if (threadIdx.x + it * nthreads < stage_words) load(img, i0, j0, w, pf[it][0], pf[it][1]);
      w.advance(drow, dcol, g);
    }
  }

  __device__ void stage(int tile_id) {
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
      int i0, j0;
      const float* img = origin(tile_id, i0, j0);
      w.start(rest, g);
      for (int e = rest; e < stage_words; e += nthreads) {
        float v0, v1;
        load(img, i0, j0, w, v0, v1);
        put(w, v0, v1);
        w.advance(drow, dcol, g);
      }
    }
  }
};

// Taps q = 0 .. ntap - 1 of 4 adjacent pixels in order, one fmaf each, two
// per weight word of each pixel's row: per tap the 4 tile values come from
// three 4-byte loads and two funnel shifts (0 or 16 bits by the parity of
// the tap's column offset, with no branch). tbase: the tile word of a
// thread's pixel 0 at tap offset (0, 0); offs: per tap the word offset
// from it and the shift, 16-byte aligned.
__device__ __forceinline__ void accumulate(const unsigned int* tbase, const int* offs,
                                           const unsigned int* const (&wrow)[kPx], int ntap,
                                           float (&acc)[kPx]) {
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
}

// A thread's 4 pixels of one tile pass, read: their buckets from bmap and,
// with `resume`, the sums a previous split left in optr (this thread's own
// stores, read through L2). `vec`: the plane width is a multiple of 4
// (16-byte loads); otherwise the `cols` pixels left in the row are read one
// at a time.
__device__ __forceinline__ void load_pixels(const int* __restrict__ bmap, const float* optr,
                                            bool vec, int cols, bool resume, int (&bk)[kPx],
                                            float (&acc)[kPx]) {
  if (vec) {
    const int4 b4 = *reinterpret_cast<const int4*>(bmap);
    bk[0] = b4.x;
    bk[1] = b4.y;
    bk[2] = b4.z;
    bk[3] = b4.w;
  } else {
#pragma unroll
    for (int k = 0; k < kPx; ++k) bk[k] = k < cols ? bmap[k] : -1;
  }
#pragma unroll
  for (int k = 0; k < kPx; ++k) acc[k] = 0.0f;
  if (resume) {
    if (vec) {
      const float4 a = __ldcg(reinterpret_cast<const float4*>(optr));
      acc[0] = a.x;
      acc[1] = a.y;
      acc[2] = a.z;
      acc[3] = a.w;
    } else {
#pragma unroll
      for (int k = 0; k < kPx; ++k)
        if (k < cols) acc[k] = __ldcg(optr + k);
    }
  }
}

// The same 4 pixels computed and written to optr: each pixel's weights from
// its bucket's row of rows_s (rw words a row), taps 0 .. ntap - 1 summed
// onto acc; with `finish` a bucket outside [0, nbucket) gives 0.
__device__ __forceinline__ void apply_pixels(const int (&bk)[kPx], float (&acc)[kPx], float* optr,
                                             bool vec, int cols, const unsigned int* rows_s,
                                             int rw, int nbucket, const unsigned int* tbase,
                                             const int* offs, int ntap, bool finish) {
  const unsigned int* wrow[kPx];
  bool ok[kPx];
#pragma unroll
  for (int k = 0; k < kPx; ++k) {
    ok[k] = bk[k] >= 0 && bk[k] < nbucket;
    wrow[k] = rows_s + (ok[k] ? bk[k] * rw : 0);
  }
  accumulate(tbase, offs, wrow, ntap, acc);
  if (finish) {
#pragma unroll
    for (int k = 0; k < kPx; ++k) acc[k] = ok[k] ? acc[k] : 0.0f;
  }
  if (vec) {
    *reinterpret_cast<float4*>(optr) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
#pragma unroll
    for (int k = 0; k < kPx; ++k)
      if (k < cols) optr[k] = acc[k];
  }
}

// A tap's (plane, row offset, column offset) as its word offset from a
// thread's pixel-0 word and its funnel shift.
__device__ __forceinline__ void tap_entry(const int* tq, const Tile& g, int* dst) {
  const int off = 2 * (tq[0] * g.plane_words + tq[1] * g.pitch) + tq[2];
  dst[0] = off >> 1;
  dst[1] = (off & 1) * 16;
}

}  // namespace ocvk_apply
