// RAISR gradient hash in parity-plane space.
//
// Replaces the TPU kernel oclcomputervision_tpu/ops/pallas/raisr_pallas.py,
// hash_planes_pallas (body _make_hash_kernel).
//
// Per HR pixel: Sobel gradients gx, gy of the cheap-upscaled luma; the
// products gx*gx, gx*gy, gy*gy blurred by the separable 9x9 sigma=2 window
// (vertical pass, then horizontal); the eigen analysis of the 2x2 structure
// tensor; and the bucket (angle * ns + strength) * nc + coherence. Plane-space
// offsets follow _read_phases: HR pixel (s*i + a, s*j + b) is element (i, j)
// of plane a*s + b, shifted by the plane origin hp.
//
// The arithmetic is the plain version's (kernels/raisr.hash_planes, the XLA
// twin ops/raisr.hash_planes), expression for expression and in its order:
// the Sobel taps row-major with zeros skipped, each blur pass summed
// k1[0]*x0 + k1[1]*x1 + ... + k1[8]*x8 left to right, the angle from atan2f,
// three sqrtf and IEEE divisions, no fused multiply-add (-fmad=false). It
// must stay so. The TPU kernel's default form (symmetric-pair blur, a ratio
// angle test, sqrt-free coherence) disagrees with the XLA twin on 10 of
// 65,536 plane pixels of uniformly random 128^2 content at x2 (agreement
// 0.99985, below the 0.9999 contract; measured on the CPU when this form was
// chosen); every such flip is an angle-bin
// neighbour at pi/2, where l1 - td cancels, so any change of rounding decides
// those pixels. Tensor cores are no help for the same reason: a banded TF32
// product for the horizontal blur rounds the taps and flips buckets, and the
// whole blur is only ~100 f32 operations per pixel.
//
// What bounds it on the H100: issued instructions. It moves 8 bytes per HR
// pixel (4 of luma in, 4 of bucket out: 0.171 ms at 16 x 2048^2 and
// 3.35 TB/s), and the function is ~150 f32 operations per pixel (0.15 ms at
// 67 TFLOP/s), counting atan2f, each sqrtf and each division once; compiled,
// those seven take about half of the ~380 instructions a pixel issues. The
// first form took 2.59 ms: a 32 x 32 HR tile in shared memory with a
// 1.7x luma halo, run-time scale and blur length (integer divisions for
// every index, k1 loaded from memory in loops that did not unroll).
// Design: scale S is a template constant and the blur length is 9, so no
// division is left (plane phases are shifts, or a multiply-shift at x3), and
// the taps and quantizers come by value in the kernel's parameters (constant
// bank operands, no loads); the quantizers are NaN-padded to four, so each
// is one compare with no count to test. A block of 128 threads owns a strip
// of 120 HR columns x 128 HR rows (126 at x3) of one image; thread e owns
// extended column e (the strip plus the 4-column blur halo each side) and
// streams down it two rows per step: it stages two luma rows (130 columns,
// loaded into registers a step ahead) in a 6-row ring in shared memory,
// takes Sobel and the three products, keeps the last ten rows of products in
// registers (a ring whose slots are compile-time indices: one switch per
// step picks the rotation), and finishes both rows' vertical pass there with
// no shared-memory round trip. The vertical results go to a double buffer in
// shared memory, de-interleaved by column phase with a stride of 80/43/40
// words at x2/x3/x4 so that both the column-order writes and the
// phase-order reads of the horizontal pass are conflict-free; one step later
// the first 120 threads, one per output column ordered by (column phase,
// plane column), run the horizontal pass, the eigen analysis of both rows
// and stores coalesced along plane columns. One barrier per two rows.
// Measured (NVIDIA H100 80GB HBM3, 700 W power limit, chip_smoke.py at the
// bench shape): 1.1672 ms; one row per step 1.4294, two rows per step at 64
// rows 1.3154 and at 128 rows 1.2884 before the quantizer padding, 256 rows
// 1.2120 (PERF.md).
#include <cuda_runtime.h>

constexpr int kTaps = 9;      // blur length (gauss_len)
constexpr int kMaxQuant = 4;  // quantizers of a kind, NaN-padded

// by value in the kernel's parameter space: the same layout as
// kernels/raisr.HashParams (ctypes). Outside the anonymous namespace, so that
// the C entry point that takes it keeps external linkage.
struct HashParams {
  float k1[kTaps];
  float squant[kMaxQuant];
  float cquant[kMaxQuant];
  int na, ns, nc;
};

namespace {

constexpr int kThreads = 128;               // one thread per extended HR column
constexpr int kG = kTaps / 2;               // blur reach
constexpr int kTileW = kThreads - 2 * kG;   // HR output columns per block
constexpr int kLumaW = kThreads + 2;        // luma columns (Sobel reach 1)
constexpr int kRowsTarget = 128;            // HR rows per block, rounded down to 2 S
constexpr int kPair = 2;                    // HR rows per step
constexpr int kRing = 6;                    // luma rows in flight: a step's 4 and the next 2
constexpr int kSlots = kTaps + 1;           // product rows kept in registers
constexpr float kPi = 3.14159265358979323846f;

// words per column phase of the vertical-pass buffer: at least
// ceil(kThreads / S), and congruent to ceil(32 / S) mod 32, so that the 32
// lanes of a warp (consecutive columns, S phases) land on 32 banks
__host__ __device__ constexpr int phase_stride(int s) {
  const int n = (kThreads + s - 1) / s;
  const int want = (32 + s - 1) / s;
  return n + ((want - n) % 32 + 32) % 32;
}

// the products of two new rows into ring slots 2J and 2J+1; with `vert`,
// the vertical pass of both, each over its nine rows, oldest first
template <int J>
__device__ __forceinline__ void ring_pair(float (&p)[3][kSlots], const float (&g)[kPair][3],
                                          bool vert, const HashParams& prm, float* __restrict__ vout,
                                          int vstride) {
#pragma unroll
  for (int i = 0; i < kPair; ++i) {
#pragma unroll
    for (int q = 0; q < 3; ++q) p[q][(2 * J + i) % kSlots] = g[i][q];
  }
  if (!vert) return;
#pragma unroll
  for (int i = 0; i < kPair; ++i) {
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      float acc = prm.k1[0] * p[q][(2 * J + i + 2) % kSlots];
#pragma unroll
      for (int u = 1; u < kTaps; ++u) acc = acc + prm.k1[u] * p[q][(2 * J + i + 2 + u) % kSlots];
      vout[(i * 3 + q) * vstride] = acc;
    }
  }
}

// bucket of one pixel from its blurred tensor (ta, tb; tb, td)
__device__ __forceinline__ int bucket(float ta, float tb, float td, const HashParams& prm) {
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
  int ai = static_cast<int>(theta / kPi * static_cast<float>(prm.na));
  ai = min(max(ai, 0), prm.na - 1);
  int si = 0, ci = 0;  // NaN padding compares false
#pragma unroll
  for (int k = 0; k < kMaxQuant; ++k) {
    si += l1 >= prm.squant[k];
    ci += coh >= prm.cquant[k];
  }
  return (ai * prm.ns + si) * prm.nc + ci;
}

template <int S>
__global__ void __launch_bounds__(kThreads, 4) raisr_hash_kernel(
    const float* __restrict__ planes, int* __restrict__ out, const HashParams prm,
    int hp, int rows, int wq, int h2p, int w2p) {
  constexpr int kRows = kRowsTarget / (kPair * S) * (kPair * S);  // HR rows per block
  constexpr int kPhase = phase_stride(S);
  constexpr int kVWords = S * kPhase;         // one product's row in vbuf
  constexpr int kPlaneCols = kTileW / S;      // plane columns per block
  __shared__ float luma[kRing][kLumaW];
  __shared__ float vbuf[2][kPair * 3 * kVWords];

  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kTileW;  // HR column of output 0 (a multiple of S)
  const int r0 = blockIdx.y * kRows;   // HR row of output 0 (a multiple of 2 S)
  const int plane = rows * wq;
  const float* img = planes + static_cast<size_t>(blockIdx.z) * (S * S) * plane;

  // luma column k * kThreads + tid is HR column c0 - kG - 1 + it; shifted by
  // S*hp >= kG + 1 it is never negative, so / and % by S are plane column
  // and column phase. Reads past the planes' last row or column give 0: only
  // outputs that are not written see them.
  int col_off[2];
  bool col_ok[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int e = k * kThreads + tid;
    const int cc = c0 - kG - 1 + e + S * hp;
    const int pc = cc / S;
    col_ok[k] = e < kLumaW && pc < wq;
    col_off[k] = (cc - pc * S) * plane + pc;
  }
  int lrow = r0 - kG - 1 + S * hp;  // next luma row to load, shifted likewise
  int la = lrow % S;
  int lpr = lrow / S;
  // luma rows are loaded into registers one step before they are stored to
  // the ring, so their latency hides behind a step of arithmetic
  float nxt[kPair][2];
  auto fetch_rows = [&]() {
#pragma unroll
    for (int i = 0; i < kPair; ++i) {
      const bool row_ok = lpr < rows;
      const float* base = img + static_cast<size_t>(la * S) * plane + static_cast<size_t>(lpr) * wq;
#pragma unroll
      for (int k = 0; k < 2; ++k) nxt[i][k] = (row_ok && col_ok[k]) ? __ldg(base + col_off[k]) : 0.0f;
      if (++la == S) {
        la = 0;
        ++lpr;
      }
    }
  };
  auto put_rows = [&](int slot) {  // rows to ring slots slot, slot + 1
#pragma unroll
    for (int i = 0; i < kPair; ++i) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (k * kThreads + tid < kLumaW) luma[slot + i][k * kThreads + tid] = nxt[i][k];
      }
    }
  };

  // where thread tid's vertical results go: extended column tid, by phase
  const int vslot = (tid % S) * kPhase + tid / S;
  // the horizontal pass: output pixel x = S*j + b of the strip, thread
  // b * kPlaneCols + j; tap u reads extended column x + u
  const bool out_thread = tid < kTileW;
  const int ob = tid / kPlaneCols;
  const int oj = tid - ob * kPlaneCols;
  int hoff[kTaps];
#pragma unroll
  for (int u = 0; u < kTaps; ++u) hoff[u] = ((ob + u) % S) * kPhase + oj + (ob + u) / S;
  const int gj = c0 / S + oj;  // plane column of the output
  const bool col_out = out_thread && gj < w2p;

  float p[3][kSlots];
  // product rows r0 - kG .. r0 + kRows + kG - 1, two per step
  constexpr int kPairs = (kRows + 2 * kG) / kPair;
  constexpr int kFirstVert = 2 * kG / kPair;  // the first step with nine rows in the ring
  fetch_rows();
  put_rows(0);
  fetch_rows();
  int s0 = 0;  // luma ring slot of the step's top row
  for (int t = 0; t <= kPairs; ++t) {
    if (t < kPairs) {  // luma rows 2t + 2, 2t + 3 to the ring, the next two on their way
      put_rows(s0 + 2 < kRing ? s0 + 2 : s0 + 2 - kRing);
      if (t + 1 < kPairs) fetch_rows();
    }
    __syncthreads();

    // horizontal pass, eigen analysis and bucket of the two rows whose
    // vertical pass ran in the previous step
    if (t > kFirstVert && col_out) {
      const float* vb = vbuf[(t - 1) & 1];
      float st[kPair][3];
#pragma unroll
      for (int i = 0; i < kPair; ++i) {
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const float* row = vb + (i * 3 + q) * kVWords;
          float acc = prm.k1[0] * row[hoff[0]];
#pragma unroll
          for (int u = 1; u < kTaps; ++u) acc = acc + prm.k1[u] * row[hoff[u]];
          st[i][q] = acc;
        }
      }
#pragma unroll
      for (int i = 0; i < kPair; ++i) {
        const int orow = r0 + kPair * (t - 1 - kFirstVert) + i;  // HR row
        const int gi = orow / S;
        const int bk = bucket(st[i][0], st[i][1], st[i][2], prm);
        if (gi < h2p) {
          const int p_out = (orow - gi * S) * S + ob;
          out[((static_cast<size_t>(blockIdx.z) * (S * S) + p_out) * h2p + gi) * w2p + gj] = bk;
        }
      }
    }

    // Sobel and products of rows 2t, 2t + 1 at extended column tid; their
    // vertical pass once nine rows of each are in the ring
    if (t < kPairs) {
      float g[kPair][3];
#pragma unroll
      for (int i = 0; i < kPair; ++i) {
        const int sa = s0 + i, sb = s0 + i + 1, sc = s0 + i + 2;
        const float* top = luma[sa < kRing ? sa : sa - kRing] + tid;
        const float* mid = luma[sb < kRing ? sb : sb - kRing] + tid;
        const float* bot = luma[sc < kRing ? sc : sc - kRing] + tid;
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
        g[i][0] = gx * gx;
        g[i][1] = gx * gy;
        g[i][2] = gy * gy;
      }
      const bool vert = t >= kFirstVert;
      float* vout = vbuf[t & 1] + vslot;
      switch (t % (kSlots / kPair)) {
        case 0: ring_pair<0>(p, g, vert, prm, vout, kVWords); break;
        case 1: ring_pair<1>(p, g, vert, prm, vout, kVWords); break;
        case 2: ring_pair<2>(p, g, vert, prm, vout, kVWords); break;
        case 3: ring_pair<3>(p, g, vert, prm, vout, kVWords); break;
        default: ring_pair<4>(p, g, vert, prm, vout, kVWords); break;
      }
      s0 = s0 + kPair < kRing ? s0 + kPair : s0 + kPair - kRing;
    }
  }
}

template <int S>
cudaError_t launch(const float* planes, int* out, const HashParams& prm, int nimg, int hp,
                   int rows, int wq, int h2p, int w2p, cudaStream_t stream) {
  constexpr int kRows = kRowsTarget / (kPair * S) * (kPair * S);
  const dim3 grid((S * w2p + kTileW - 1) / kTileW, (S * h2p + kRows - 1) / kRows, nimg);
  raisr_hash_kernel<S><<<grid, kThreads, 0, stream>>>(planes, out, prm, hp, rows, wq, h2p, w2p);
  return cudaGetLastError();
}

}  // namespace

// prm: host pointer to the taps and quantizers (kernels/raisr.HashParams).
// Scale 2-4, blur length 9; planes [nimg, s*s, rows, wq] with origin (hp, hp),
// hp >= ceil(4 / s) + 1, rows >= h2p + 2 hp, wq >= w2p + 2 hp.
extern "C" int ocvk_raisr_hash(const float* planes, int* out, const HashParams* prm, int nimg,
                               int s, int hp, int rows, int wq, int h2p, int w2p,
                               void* stream) {
  if (s * hp < kG + 1 ||
      static_cast<long long>(s) * s * rows * wq >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (s) {
    case 2: return static_cast<int>(launch<2>(planes, out, *prm, nimg, hp, rows, wq, h2p, w2p, st));
    case 3: return static_cast<int>(launch<3>(planes, out, *prm, nimg, hp, rows, wq, h2p, w2p, st));
    case 4: return static_cast<int>(launch<4>(planes, out, *prm, nimg, hp, rows, wq, h2p, w2p, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
