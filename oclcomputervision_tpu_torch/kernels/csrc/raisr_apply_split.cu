// RAISR per-pixel filter select and apply in parity-plane space, for banks
// of which one phase does not fit a block's shared memory beside its tile:
// any scale, filter length and bucket count, read at run time, the bank
// split by tap range into parts that each fit.
//
// Replaces, with raisr_apply.cu and raisr_apply_generic.cu, the TPU kernel
// oclcomputervision_tpu/ops/pallas/raisr_pallas.py, _apply_phase (body
// _make_kernel), which is written for any filter_len and scale.
// kernels/raisr.apply_form sends a config here when not even one phase's
// bank fits the generic form's block (generic_apply_phases returns 0: for
// example x2, filter length 17 and 432 buckets, 145 words x 432 rows =
// 250,560 bytes a phase; or a scale whose s*s planes' tile does not fit).
// The launches count as raisr_apply_split.
//
// Output pixel (y, x) of phase t = (py, px) of image n, as raisr_apply.cu:
//   out = sum_q bf16(tap_q) * bf16(bank[t][bucket][q]),  q = ti*fl + tj,
// tap_q from plane ((py - m + ti) mod s, (px - m + tj) mod s) at plane
// (y + hp + floor((py - m + ti)/s), x + hp + floor((px - m + tj)/s)),
// bucket = buckets[n % B][t][y][x]; q summed in order with one fmaf per tap
// (a bf16 x bf16 product is exact in f32), so it equals the plain version
// bit for bit. A bucket outside [0, nbucket) gives 0.
//
// What bounds it on the H100: as raisr_apply_generic.cu, the issued
// instructions of the tap loop (about 25 a tap for 4 pixels: the tap loads
// and their unpacking, each pixel's weight load from its own row).
//
// Design: raisr_apply_generic.cu's block for one resident phase, with the
// phase's bank cut into `nsplit` splits of q consecutive taps (q even),
// kernels/raisr.split_plan choosing the fewest that let two blocks share an
// SM (else the fewest that fit one):
//  - Split k holds taps [k q, (k + 1) q) of every bucket row of its phase,
//    odd_words(q) words a row, so every pixel is computed in every split
//    (no pixel selection, no load imbalance between splits) and the splits
//    together cover each (bucket, tap) once.
//  - Persistent blocks, s*s groups of streams (one phase each); a block runs
//    the splits in order over the same tiles: per split it loads the split's
//    rows, tap table and plane list, then walks its tiles. A thread's
//    partial sums go to the output and come back, through L2, to the same
//    thread in the next split, which goes on with the taps in order: the
//    order and rounding are those of one pass, so the result is bit-exact.
//    The extra traffic is 8 bytes per pixel per split boundary.
//  - The tile holds only the planes the split's taps read (all s*s while
//    the split spans a tap row at least s taps long; fewer for long splits
//    of large scales): any config fits with enough splits, so this form
//    takes every config plane_geometry admits, with no limit on the batch.
//  - The tile, its staging and the tap loop are raisr_apply_generic.cu's
//    (raisr_apply_tile.cuh); with one phase a block has 256 threads, and the
//    first 16 tile words a thread are prefetched into registers (all of
//    the tile at x2 and filter length 17: 14 words a thread), the next
//    tile's buckets and partial sums with them.
// What holds it now: warps to hide the shared-memory loads' latency. At x2,
// filter length 17 (NVIDIA H100 80GB HBM3, 700 W, kernels/forms.py, 16 x
// 1024^2): 2 splits with one block an SM 12.20 ms; 3 splits with two
// blocks an SM 9.46 ms (2.05 G taps/ms; the generic form does 2.7 at
// filter length 13 with 16 warps an SM); 4 blocks an SM at 64 registers a
// thread, 3-7 splits, 11.1-13.9 ms. Loading the next tile's buckets and
// partial sums ahead of it (their latency stalled the start of every
// tile) took 2 splits from 16.08 to 12.20 ms.
// A one-thread-per-pixel form that read the filter rows through L1 and L2
// (32 lanes, 32 rows of a 1 MB bank) did 0.46 G taps/ms: 38.6523 ms at
// 16 x 1024^2, x2 filter length 17, 432 buckets (NVIDIA H100 80GB HBM3,
// 700 W, PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "raisr_apply_tile.cuh"

namespace {

using namespace ocvk_apply;

constexpr int kPrefetch = 16;  // tile words per thread loaded ahead into registers
constexpr int kMinBlocks = 2;  // blocks an SM the register budget must allow (128 a thread)
constexpr int kHead = 4;       // ints of a plan record before its plane list

// A plan record per (phase, split), kernels/raisr.split_plan's table:
// [nplanes, first tap, taps, 0, planes[maxp], taps[q][3]], each tap its
// staged plane, row offset and column offset.
__host__ __device__ inline int record_ints(int q, int maxp) { return kHead + maxp + 3 * q; }

// Dynamic shared memory: a split's rows (rounded up to 16 bytes), its tap
// table (a word offset and a shift per tap; q even keeps 16-byte
// alignment), the plane list (rounded up to 4) and the tile of maxp planes.
// kernels/raisr.split_apply_smem computes the same in Python;
// ocvk_raisr_apply_split_smem exports this, which chip_smoke.py holds equal.
__host__ __device__ inline long long smem_bytes(int s, int fl, int nbucket, int q, int maxp) {
  const long long bank = (static_cast<long long>(nbucket) * odd_words(q) + 3) / 4 * 4;
  return 4 * (bank + 2LL * q + (maxp + 3) / 4 * 4 +
              static_cast<long long>(tile_geometry(s, fl, maxp).words));
}

__global__ void __launch_bounds__(kGroup, kMinBlocks) raisr_apply_split_kernel(
    const float* __restrict__ planes, const int* __restrict__ buckets,
    const unsigned int* __restrict__ bank, const int* __restrict__ plan,
    float* __restrict__ out, int nimg, int nb, int s, int fl, int hp, int rows, int wq,
    int h2p, int w2p, int nbucket, int nsplit, int q, int maxp, int tiles_y, int tiles_x,
    int nstreams) {
  extern __shared__ uint4 smem[];
  const int ss = s * s;
  const int rw = odd_words(q);
  const Tile g = tile_geometry(s, fl, maxp);
  const int phase_words = nbucket * rw;
  unsigned int* bank_s = reinterpret_cast<unsigned int*>(smem);
  int* tap_s = reinterpret_cast<int*>(bank_s + (phase_words + 3) / 4 * 4);
  int* plist_s = tap_s + 2 * q;
  unsigned int* tile_w = reinterpret_cast<unsigned int*>(plist_s + (maxp + 3) / 4 * 4);

  const int t = blockIdx.x % ss;
  const int lx = threadIdx.x % (kTileW / kPx);
  const int ly = threadIdx.x / (kTileW / kPx);
  // element index of pixel 0 at tap offset (0, 0) in staged plane 0
  const int base = 2 * (ly + g.reach) * g.pitch + g.padl + kPx * lx;
  const size_t plane_px = static_cast<size_t>(h2p) * w2p;
  const int ntiles = nimg * tiles_y * tiles_x;
  const bool vec = w2p % 4 == 0;
  Stager<kPrefetch, true> st(planes, plist_s, tile_w, g, s, hp, rows, wq, tiles_y, tiles_x,
                             kGroup);

  for (int k = 0; k < nsplit; ++k) {
    const int* rec = plan + static_cast<size_t>(t * nsplit + k) * record_ints(q, maxp);
    const int nplanes = rec[0];
    const int ntap = rec[2];
    __syncthreads();  // the previous split's readers are done
    const unsigned int* src = bank + (static_cast<size_t>(k) * ss + t) * phase_words;
    for (int e = threadIdx.x; e < phase_words; e += kGroup) bank_s[e] = src[e];
    for (int e = threadIdx.x; e < nplanes; e += kGroup) plist_s[e] = rec[kHead + e];
    for (int e = threadIdx.x; e < ntap; e += kGroup)
      tap_entry(rec + kHead + maxp + 3 * e, g, tap_s + 2 * e);
    st.set_planes(nplanes);
    __syncthreads();  // the plane list is in place for the staging

    // a thread's pixels of a tile: in the planes at all, and their offset
    auto pixels_of = [&](int tile_id, size_t& bo, size_t& oo) {
      const int tx = tile_id % tiles_x;
      const int rest = tile_id / tiles_x;
      const int n = rest / tiles_y;
      const int gi = (rest % tiles_y) * kTileH + ly;
      const int gj = tx * kTileW + kPx * lx;
      const size_t o = static_cast<size_t>(t) * plane_px + static_cast<size_t>(gi) * w2p + gj;
      bo = static_cast<size_t>(n % nb) * ss * plane_px + o;
      oo = static_cast<size_t>(n) * ss * plane_px + o;
      return gi < h2p && gj < w2p ? w2p - gj : 0;
    };
    // the next tile's buckets and partial sums travel with its tile words
    int bk[kPx];
    float acc[kPx];
    int tile_id = blockIdx.x / ss;
    if (tile_id < ntiles) {
      size_t bo, oo;
      const int cols = pixels_of(tile_id, bo, oo);
      if (cols) load_pixels(buckets + bo, out + oo, vec, cols, k > 0, bk, acc);
      st.fetch(tile_id);
      st.stage(tile_id);
    }
    for (; tile_id < ntiles; tile_id += nstreams) {
      __syncthreads();  // the tile (and, the first time, the split's rows and taps) is in place
      const int next = tile_id + nstreams;
      size_t bo, oo, nbo = 0, noo = 0;
      const int cols = pixels_of(tile_id, bo, oo);
      const int ncols = next < ntiles ? pixels_of(next, nbo, noo) : 0;
      int nbk[kPx];
      float nacc[kPx];
      if (ncols) load_pixels(buckets + nbo, out + noo, vec, ncols, k > 0, nbk, nacc);
      if (next < ntiles) st.fetch(next);
      if (cols)
        apply_pixels(bk, acc, out + oo, vec, cols, bank_s, rw, nbucket, tile_w + (base >> 1),
                     tap_s, ntap, k == nsplit - 1);
#pragma unroll
      for (int j = 0; j < kPx; ++j) {
        bk[j] = nbk[j];
        acc[j] = nacc[j];
      }
      __syncthreads();  // every reader of the tile is done
      if (next < ntiles) st.stage(next);
    }
  }
}

}  // namespace

// bank: [nsplit, s*s, nbucket, odd_words(q)] 4-byte words, split k of row
// [t, b] taps [k q, (k + 1) q) of filter b * s*s + t as bf16 and zero
// padding (kernels/raisr._bank_rows), 4-byte aligned. plan: int32
// [s*s, nsplit, record_ints(q, maxp)] (kernels/raisr.split_plan). Planes
// [nimg, s*s, rows, wq] with origin (hp, hp), hp >= ceil((fl/2)/s), rows >=
// h2p + 2 hp, wq >= w2p + 2 hp; buckets [nb, s*s, h2p, w2p], nimg a
// multiple of nb; any w2p and any batch.
extern "C" int ocvk_raisr_apply_split(const float* planes, const int* buckets, const void* bank,
                                      const int* plan, float* out, int nimg, int nb, int s,
                                      int fl, int hp, int rows, int wq, int h2p, int w2p,
                                      int nbucket, int rwords, int nsplit, int q, int maxp,
                                      void* stream) {
  const long long ntap = static_cast<long long>(fl) * fl;
  if (s < 1 || fl < 1 || nbucket < 1 || q < 2 || q % 2 != 0 || rwords != odd_words(q) ||
      nsplit < 1 || static_cast<long long>(nsplit) * q < ntap ||
      static_cast<long long>(nsplit - 1) * q >= ntap || maxp < 1 || maxp > s * s ||
      maxp > q || nb < 1 || nimg % nb != 0 || hp < tile_geometry(s, fl, 1).reach ||
      (reinterpret_cast<uintptr_t>(bank) & 3u) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long smem = smem_bytes(s, fl, nbucket, q, maxp);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_y = (h2p + kTileH - 1) / kTileH;
  const int tiles_x = (w2p + kTileW - 1) / kTileW;
  const long long ntiles = static_cast<long long>(nimg) * tiles_y * tiles_x;
  if (ntiles > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = raisr_apply_split_kernel;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kGroup,
                                                      static_cast<size_t>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  // persistent blocks: per phase, as many as fill the card or as there are tiles
  long long nstreams = static_cast<long long>(sms) * per_sm / (s * s);
  if (nstreams < 1) nstreams = 1;
  if (nstreams > ntiles) nstreams = ntiles;
  kernel<<<static_cast<unsigned int>(nstreams * s * s), kGroup, static_cast<size_t>(smem),
           static_cast<cudaStream_t>(stream)>>>(
      planes, buckets, static_cast<const unsigned int*>(bank), plan, out, nimg, nb, s, fl, hp,
      rows, wq, h2p, w2p, nbucket, nsplit, q, maxp, tiles_y, tiles_x,
      static_cast<int>(nstreams));
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of a launch, as the entry point above computes it
// (for the check against kernels/raisr.split_apply_smem).
extern "C" long long ocvk_raisr_apply_split_smem(int s, int fl, int nbucket, int q, int maxp) {
  return smem_bytes(s, fl, nbucket, q, maxp);
}
