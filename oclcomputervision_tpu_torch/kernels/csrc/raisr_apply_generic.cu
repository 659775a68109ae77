// RAISR per-pixel filter select and apply in parity-plane space, generic
// form: any scale and filter length, read at run time, with the bank
// resident in shared memory.
//
// Replaces, with raisr_apply.cu and raisr_apply_split.cu, the TPU kernel
// oclcomputervision_tpu/ops/pallas/raisr_pallas.py, _apply_phase (body
// _make_kernel), which is written for any filter_len and scale.
// raisr_apply.cu is compiled for filter length 11 at scales 2-4;
// kernels/raisr.apply_form sends every other config here when one phase's
// bank and a tile fit a block's shared memory (generic_apply_phases), and to
// raisr_apply_split.cu otherwise. The launches count as
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
// from registers fixed at compile time. A one-thread-per-pixel form that
// read every tap and weight through L1 did 0.46 G taps/ms against
// raisr_apply.cu's 5.2.
//
// Design, raisr_apply.cu's carried over to a run-time scale and filter
// length (the tile, its staging and the tap loop in raisr_apply_tile.cuh,
// which raisr_apply_split.cu shares):
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
// 30.4729 ms; the one-thread-per-pixel form 22.9982 and 106.0459 ms
// (PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "raisr_apply_tile.cuh"

namespace {

using namespace ocvk_apply;

constexpr int kMaxPhases = 4;  // resident phases: at most 1024 threads
constexpr int kPrefetch = 8;   // tile words per thread loaded ahead into registers

// kernels/raisr.generic_apply_smem computes the same sizes in Python (to
// choose the form on any device); ocvk_raisr_apply_generic_smem exports
// this file's, which chip_smoke.py holds equal to it.
__host__ __device__ inline int row_words(int fl) { return odd_words(fl * fl); }

__host__ __device__ inline int tap_stride(int fl) { return (fl * fl + 1) / 2 * 4; }

__host__ __device__ inline long long smem_bytes(int s, int fl, int nbucket, int phases) {
  const long long bank = (static_cast<long long>(phases) * nbucket * row_words(fl) + 3) / 4 * 4;
  return 4 * (bank + static_cast<long long>(phases) * tap_stride(fl) +
              tile_geometry(s, fl, s * s).words);
}

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
  const Tile g = tile_geometry(s, fl, ss);
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
    // taps [t][q] = (plane, row offset, column offset) -> word offset and
    // shift from a thread's pixel 0
    for (int e = threadIdx.x; e < nph * ntap; e += nthreads) {
      const int ph = e / ntap;
      const int q = e - ph * ntap;
      tap_entry(taps + (static_cast<size_t>(t0 + ph) * ntap + q) * 3, g,
                tap_s + ph * tstride + 2 * q);
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
  Stager<kPrefetch, false> st(planes, nullptr, tile_w, g, s, hp, rows, wq, tiles_y, tiles_x,
                              nthreads);
  st.set_planes(ss);

  int tile_id = blockIdx.x / nsets;
  if (tile_id < ntiles) {
    st.fetch(tile_id);
    st.stage(tile_id);
  }
  for (; tile_id < ntiles; tile_id += nstreams) {
    __syncthreads();  // the tile (and, the first time, the bank and taps) is in place
    const int next = tile_id + nstreams;
    if (next < ntiles) st.fetch(next);

    const int tx = tile_id % tiles_x;
    const int rest = tile_id / tiles_x;
    const int n = rest / tiles_y;
    const int gi = (rest % tiles_y) * kTileH + ly;
    const int gj = tx * kTileW + kPx * lx;
    if (computes && gi < h2p && gj < w2p) {
      const size_t o = static_cast<size_t>(t) * plane_px + static_cast<size_t>(gi) * w2p + gj;
      float* optr = out + static_cast<size_t>(n) * ss * plane_px + o;
      int bk[kPx];
      float acc[kPx];
      load_pixels(buckets + static_cast<size_t>(n % nb) * ss * plane_px + o, optr, vec, w2p - gj,
                  false, bk, acc);
      apply_pixels(bk, acc, optr, vec, w2p - gj, rows_s, rw, nbucket, tile_w + (base >> 1), offs,
                   ntap, true);
    }
    __syncthreads();  // every reader of the tile is done
    if (next < ntiles) st.stage(next);
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
      hp < tile_geometry(s, fl, 1).reach || (reinterpret_cast<uintptr_t>(bank) & 3u) != 0) {
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
