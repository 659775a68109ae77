// RAISR gradient hash in parity-plane space, generic form: any scale, blur
// length and number of quantizers, all read at run time.
//
// Replaces, with raisr_hash.cu, the TPU kernel
// oclcomputervision_tpu/ops/pallas/raisr_pallas.py, hash_planes_pallas (body
// _make_hash_kernel), which is written for any gauss_len and scale.
// raisr_hash.cu is compiled for the shipped domain (blur length 9, scales
// 2-4, at most four quantizers of a kind); kernels/raisr.hash_form sends
// every other config here, and the launches count as raisr_hash_generic.
//
// The arithmetic is raisr_hash.cu's, which is the plain version's
// (kernels/raisr.hash_planes), expression for expression and in its order:
// Sobel taps row-major with zeros skipped, the vertical then the horizontal
// blur pass summed k1[0]*x0 + k1[1]*x1 + ... left to right, the angle from
// atan2f, three sqrtf and IEEE divisions, no fused multiply-add
// (-fmad=false), one compare per quantizer.
//
// What bounds it on the H100: as raisr_hash.cu, issued instructions. A first
// generic form spent about 3x the compiled form's time per HR pixel: a run-time
// division for every staged luma element, taps and quantizers loaded from
// device memory inside the loops, a 32 x 32 HR tile whose blur halo cost
// 1.56x the outputs at blur length 7, and four stages through shared memory
// with a barrier each.
// Design, raisr_hash.cu's streaming walk with a run-time scale and blur
// length: a block of 128 threads owns a strip of 128 - 2g HR columns
// (rounded down to a multiple of s) x 128 HR rows (rounded down to a
// multiple of s; fewer, down to 16, where the grid would not give each SM
// 4 blocks) of one image; thread e owns extended column e (the strip plus
// the blur halo each side) and streams down it one row per step. The
// HR -> plane mapping is worked out once per thread for its columns and
// carried from row to row for the rows, so no element needs a division.
// Per step a thread stores one luma row (loaded into registers a step
// ahead) to a 4-row ring in shared memory, takes Sobel and the three
// products of its column (each product row computed once) and runs the
// vertical pass of the last gl rows into a double-buffered row,
// de-interleaved by column phase (raisr_hash.cu's phase stride) so that the
// horizontal pass reads it without bank conflicts. One step later the
// first 128 - 2g threads, one per output column ordered by (column phase,
// plane column), run the horizontal pass (each vertical value read once
// per tap), the eigen analysis and stores coalesced along plane columns.
// One barrier per step. At blur lengths 5-13 (odd) the kernel is compiled
// for the length: the ring of product rows, the taps and the horizontal
// pass's offsets live in registers (slots fixed at compile time, one
// branch per step picks the rotation). Any other length keeps them in
// shared memory (the taps and quantizers are staged there once per block
// for every length) and walks the taps in loops.
// Measured at the bench geometry (NVIDIA H100 80GB HBM3, 700 W,
// kernels/forms.py, 16 x 1024^2): gauss_len 7 at x2 1.3404 ms, x5 8.7232 ms;
// that first form 2.9861 and 19.6518 ms; this one with the ring in shared
// memory, in another call, 1.5765 and 10.2629 ms against 1.3449 and 8.7240
// (PERF.md).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;     // one thread per extended HR column
constexpr int kLumaW = kThreads + 2;  // luma columns (Sobel reach 1)
constexpr int kRowsTarget = 128;  // HR rows per block, rounded down to a multiple of s
constexpr int kRowsMin = 16;      // fewest HR rows per block when the grid is small
constexpr int kBlocksPerSm = 4;   // blocks per SM a grid of shorter strips aims at
constexpr int kRing = 4;          // luma rows in the ring: a step's 3 and the next
constexpr float kPi = 3.14159265358979323846f;

// words per column phase of the vertical-pass row: at least
// ceil(kThreads / s), and congruent to ceil(32 / s) mod 32, as raisr_hash.cu
__host__ __device__ inline int phase_stride(int s) {
  const int n = (kThreads + s - 1) / s;
  const int want = (32 + s - 1) / s;
  return n + ((want - n) % 32 + 32) % 32;
}

struct Geometry {
  int g, tw, ph;  // blur reach, output columns per block, phase stride
  int prod, vrow;  // floats of the product ring and of one vertical-pass buffer
};

__host__ __device__ inline Geometry geometry(int s, int gl) {
  Geometry q;
  q.g = gl / 2;
  q.tw = (kThreads - 2 * q.g) / s * s;
  q.ph = phase_stride(s);
  q.prod = gl * 3 * kThreads;
  q.vrow = 3 * s * q.ph;
  return q;
}

__host__ __device__ inline size_t smem_bytes(int s, int gl, int nsq, int ncq) {
  const Geometry q = geometry(s, gl);
  return sizeof(float) * (static_cast<size_t>(kRing) * kLumaW + q.prod + 2 * q.vrow + gl + nsq +
                          ncq);
}

// At a blur length G known at compile time: the taps, the ring of G
// product rows and the horizontal pass's offsets in registers.
template <int G>
struct RegRing {
  float k[G];
  float p[3][G];
  int hoff[G];
};

// the products of row t into slot J = t % G; with `vert`, the vertical pass
// of rows t - G + 1 .. t, oldest (slot J + 1) first
template <int G, int J>
__device__ __forceinline__ void ring_row(RegRing<G>& r, const float (&g3)[3], bool vert,
                                         float* __restrict__ vout, int qs) {
#pragma unroll
  for (int q = 0; q < 3; ++q) r.p[q][J] = g3[q];
  if (!vert) return;
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    float acc = r.k[0] * r.p[q][(J + 1) % G];
#pragma unroll
    for (int u = 1; u < G; ++u) acc = acc + r.k[u] * r.p[q][(J + 1 + u) % G];
    vout[q * qs] = acc;
  }
}

template <int G, int J = 0>
__device__ __forceinline__ void ring_step(int slot, RegRing<G>& r, const float (&g3)[3], bool vert,
                                          float* __restrict__ vout, int qs) {
  if (slot == J) {
    ring_row<G, J>(r, g3, vert, vout, qs);
  } else if constexpr (J + 1 < G) {
    ring_step<G, J + 1>(slot, r, g3, vert, vout, qs);
  }
}

// prm: k1[gl], then nsq strength and ncq coherence quantizers, f32. G: the
// blur length gl when it is compiled in (5-13, odd), else 0
template <int G>
__global__ void __launch_bounds__(kThreads) raisr_hash_generic_kernel(
    const float* __restrict__ planes, int* __restrict__ out, const float* __restrict__ prm,
    int s, int gl, int nsq, int ncq, int na, int ns, int nc, int hp, int rows, int wq,
    int h2p, int w2p, int strip_rows, int nstrips_x) {
  extern __shared__ float smem[];
  const Geometry geo = geometry(s, gl);
  float(*luma)[kLumaW] = reinterpret_cast<float(*)[kLumaW]>(smem);  // [kRing][kLumaW]
  float* prod = smem + kRing * kLumaW;  // [gl][3][kThreads]
  float* vbuf = prod + geo.prod;        // [2][3][s * ph]
  float* k1 = vbuf + 2 * geo.vrow;
  float* squant = k1 + gl;
  float* cquant = squant + nsq;
  const int tid = threadIdx.x;
  for (int e = tid; e < gl + nsq + ncq; e += kThreads) k1[e] = prm[e];

  const int g = geo.g;
  // the grid's x runs over the strips of all rows, row-major
  const int c0 = static_cast<int>(blockIdx.x % nstrips_x) * geo.tw;  // HR column of output 0
  const int r0 = static_cast<int>(blockIdx.x / nstrips_x) * strip_rows;  // HR row of output 0
  const int nrows = min(strip_rows, s * h2p - r0);  // HR rows this block writes
  const int nprod = nrows + 2 * g;                 // product rows it computes
  const size_t plane = static_cast<size_t>(rows) * wq;
  const float* img = planes + static_cast<size_t>(blockIdx.z) * s * s * plane;

  // luma column k * kThreads + tid is HR column c0 - g - 1 + it; shifted by
  // s*hp >= g + 1 it is never negative, so / and % by s are plane column
  // and column phase, worked out once here. Reads past the planes' last row
  // or column give 0: only outputs that are not written see them.
  size_t col_off[2];
  bool col_ok[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int e = k * kThreads + tid;
    const int cc = c0 - g - 1 + e + s * hp;
    const int pc = cc / s;
    col_ok[k] = e < kLumaW && pc < wq;
    col_off[k] = (cc - pc * s) * plane + pc;
  }
  const int lrow = r0 - g - 1 + s * hp;  // luma row 0, shifted likewise
  int la = lrow % s;  // the next luma row's row phase and plane row
  int lpr = lrow / s;
  float nxt[2];
  auto fetch_row = [&]() {
    const bool row_ok = lpr < rows;
    const float* base = img + static_cast<size_t>(la * s) * plane + static_cast<size_t>(lpr) * wq;
#pragma unroll
    for (int k = 0; k < 2; ++k) nxt[k] = (row_ok && col_ok[k]) ? __ldg(base + col_off[k]) : 0.0f;
    if (++la == s) {
      la = 0;
      ++lpr;
    }
  };
  auto put_row = [&](int slot) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (k * kThreads + tid < kLumaW) luma[slot][k * kThreads + tid] = nxt[k];
    }
  };

  // where thread tid's vertical results go: extended column tid, by phase
  const int vslot = (tid % s) * geo.ph + tid / s;
  // the horizontal pass: output column x = s*oj + ob of the strip is thread
  // ob * (tw / s) + oj; its tap u reads extended column x + u
  const int pcols = geo.tw / s;
  const bool out_thread = tid < geo.tw;
  const int ob = out_thread ? tid / pcols : 0;
  const int oj = out_thread ? tid - ob * pcols : 0;
  const int gj = c0 / s + oj;  // plane column of the output
  const bool col_out = out_thread && gj < w2p;
  const int hstart = ob * geo.ph + oj;
  RegRing<(G > 0 ? G : 1)> rr;
  if constexpr (G > 0) {
#pragma unroll
    for (int u = 0; u < G; ++u) {
      rr.k[u] = __ldg(prm + u);
      rr.hoff[u] = ((ob + u) % s) * geo.ph + oj + (ob + u) / s;
    }
  }
  int oa = 0;         // row phase of the next output row
  int ogi = r0 / s;   // and its plane row

  fetch_row();
  put_row(0);
  fetch_row();
  put_row(1);
  fetch_row();
  int pslot = 0;  // product ring slot of row t: t % gl
  for (int t = 0; t <= nprod; ++t) {
    if (t < nprod) {  // luma row t + 2 to the ring, row t + 3 on its way
      put_row((t + 2) % kRing);
      if (t + 3 <= nprod + 1) fetch_row();
    }
    __syncthreads();

    // horizontal pass, eigen analysis and bucket of the row whose vertical
    // pass ran in the previous step
    if (t >= gl) {
      if (col_out) {
        const float* vb = vbuf + ((t - 1) & 1) * geo.vrow;
        const int qs = s * geo.ph;  // floats per product in the row
        float st[3];
        if constexpr (G > 0) {
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            st[q] = rr.k[0] * vb[q * qs + rr.hoff[0]];
#pragma unroll
            for (int u = 1; u < G; ++u) st[q] = st[q] + rr.k[u] * vb[q * qs + rr.hoff[u]];
          }
        } else {
        int addr = hstart, b = ob;
        for (int u = 0; u < gl; ++u) {
          const float k = k1[u];
          if (u == 0) {
#pragma unroll
            for (int q = 0; q < 3; ++q) st[q] = k * vb[q * qs + addr];
          } else {
#pragma unroll
            for (int q = 0; q < 3; ++q) st[q] = st[q] + k * vb[q * qs + addr];
          }
          addr += geo.ph;
          if (++b == s) {
            b = 0;
            addr -= qs - 1;
          }
        }
        }
        const float ta = st[0], tb = st[1], td = st[2];
        const float tr = ta + td;
        const float det = ta * td - tb * tb;
        const float disc = sqrtf(fmaxf(tr * tr / 4.0f - det, 0.0f));
        const float l1 = tr / 2.0f + disc;
        const float l2 = tr / 2.0f - disc;
        float theta = atan2f(tb, l1 - td);
        if (theta < 0.0f) theta = theta + kPi;
        const float sq1 = sqrtf(fmaxf(l1, 0.0f));
        const float sq2 = sqrtf(fmaxf(l2, 0.0f));
        const float denom = sq1 + sq2;
        const float coh = denom != 0.0f ? (sq1 - sq2) / denom : 0.0f;
        int ai = static_cast<int>(theta / kPi * static_cast<float>(na));
        ai = min(max(ai, 0), na - 1);
        int si = 0, ci = 0;
        for (int k = 0; k < nsq; ++k) si += l1 >= squant[k];
        for (int k = 0; k < ncq; ++k) ci += coh >= cquant[k];
        if (ogi < h2p) {
          const int p_out = oa * s + ob;
          out[((static_cast<size_t>(blockIdx.z) * s * s + p_out) * h2p + ogi) * w2p + gj] =
              (ai * ns + si) * nc + ci;
        }
      }
      if (++oa == s) {
        oa = 0;
        ++ogi;
      }
    }

    // Sobel and products of row t at extended column tid, into its ring
    // slot; the vertical pass once gl rows are in the ring
    if (t < nprod) {
      const float* top = luma[t % kRing] + tid;
      const float* mid = luma[(t + 1) % kRing] + tid;
      const float* bot = luma[(t + 2) % kRing] + tid;
      const float y00 = top[0], y01 = top[1], y02 = top[2];
      const float y10 = mid[0], y12 = mid[2];
      const float y20 = bot[0], y21 = bot[1], y22 = bot[2];
      float gx = -y00;
      gx = gx + y02;
      gx = gx + -2.0f * y10;
      gx = gx + 2.0f * y12;
      gx = gx + -y20;
      gx = gx + y22;
      float gy = -y00;
      gy = gy + -2.0f * y01;
      gy = gy + -y02;
      gy = gy + y20;
      gy = gy + 2.0f * y21;
      gy = gy + y22;
      if constexpr (G > 0) {
        const float g3[3] = {gx * gx, gx * gy, gy * gy};
        ring_step<G>(pslot, rr, g3, t >= G - 1, vbuf + (t & 1) * geo.vrow + vslot, s * geo.ph);
        if (++pslot == G) pslot = 0;
      } else {
      float* slot = prod + pslot * 3 * kThreads + tid;
      slot[0] = gx * gx;
      slot[kThreads] = gx * gy;
      slot[2 * kThreads] = gy * gy;
      if (++pslot == gl) pslot = 0;
      if (t >= gl - 1) {  // rows t - gl + 1 .. t, oldest first, from slot pslot
        float acc[3];
        const float* row = prod + pslot * 3 * kThreads + tid;
#pragma unroll
        for (int q = 0; q < 3; ++q) acc[q] = k1[0] * row[q * kThreads];
        int sl = pslot;
        for (int u = 1; u < gl; ++u) {
          if (++sl == gl) sl = 0;
          const float k = k1[u];
          row = prod + sl * 3 * kThreads + tid;
#pragma unroll
          for (int q = 0; q < 3; ++q) acc[q] = acc[q] + k * row[q * kThreads];
        }
        float* vout = vbuf + (t & 1) * geo.vrow + vslot;
#pragma unroll
        for (int q = 0; q < 3; ++q) vout[q * s * geo.ph] = acc[q];
      }
      }
    }
  }
}

using Kernel = void (*)(const float*, int*, const float*, int, int, int, int, int, int, int, int,
                        int, int, int, int, int, int);

// the instance for blur length gl
Kernel pick(int gl) {
  switch (gl) {
    case 5: return raisr_hash_generic_kernel<5>;
    case 7: return raisr_hash_generic_kernel<7>;
    case 9: return raisr_hash_generic_kernel<9>;
    case 11: return raisr_hash_generic_kernel<11>;
    case 13: return raisr_hash_generic_kernel<13>;
    default: return raisr_hash_generic_kernel<0>;
  }
}

}  // namespace

// prm: device pointer to the f32 taps (gl of them) followed by nsq strength
// and ncq coherence quantizers (kernels/raisr.hash_params_generic). Planes
// [nimg, s*s, rows, wq] with origin (hp, hp), s * hp >= gl / 2 + 1,
// rows >= h2p + 2 hp, wq >= w2p + 2 hp. Any scale and blur length whose
// strip keeps one output column of each phase, s + 2 (gl / 2) <= 128
// (kernels/raisr.hash_form refuses the others).
extern "C" int ocvk_raisr_hash_generic(const float* planes, int* out, const float* prm,
                                       int nimg, int s, int gl, int nsq, int ncq, int na,
                                       int ns, int nc, int hp, int rows, int wq, int h2p,
                                       int w2p, void* stream) {
  if (s < 1 || gl < 1 || nsq < 0 || ncq < 0 || s * hp < gl / 2 + 1 || nimg > 65535 ||
      static_cast<long long>(s) * s * rows * wq >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geometry q = geometry(s, gl);
  if (q.tw < s) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(s, gl, nsq, ncq);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const Kernel kernel = pick(gl);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // strips of kRowsTarget rows; shorter ones (halved, down to kRowsMin) while
  // the grid gives fewer than kBlocksPerSm blocks per SM: a strip is walked
  // one row per step, so a small image needs more strips to fill the card
  const long long gx = (static_cast<long long>(s) * w2p + q.tw - 1) / q.tw;
  int strip = kRowsTarget / s * s;
  auto strips = [&](int r) { return (static_cast<long long>(s) * h2p + r - 1) / r; };
  const int fewest = kRowsMin > s ? kRowsMin : s;
  while (strip / 2 / s * s >= fewest &&
         gx * strips(strip) * nimg < static_cast<long long>(kBlocksPerSm) * sms) {
    strip = strip / 2 / s * s;
  }
  const long long nblocks = gx * strips(strip);
  if (nblocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned int>(nblocks), 1, nimg);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      planes, out, prm, s, gl, nsq, ncq, na, ns, nc, hp, rows, wq, h2p, w2p, strip,
      static_cast<int>(gx));
  return static_cast<int>(cudaGetLastError());
}
