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
// What bounds it on the H100: as raisr_hash.cu, issued instructions, and
// this form spends more of them (run-time divisions for every plane index,
// taps and quantizers loaded from memory in loops that do not unroll).
// It is the simple form, for configs no shipped bank uses.
// Design: a block of 256 threads owns a tile of about 32 x 32 HR pixels
// (TI x TJ plane pixels of every phase, TI = TJ = max(1, 32 / s)) of one
// image and runs the stages through shared memory: the luma the tile reaches
// (blur reach + Sobel 1 on each side), then Sobel and the three products,
// then the vertical pass, then the horizontal pass, eigen analysis and the
// store, one barrier between stages. Its shared memory grows with the blur
// length and the scale (41.6 KB at 32 x 32 HR pixels and blur length 9).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileHR = 32;  // HR pixels per tile side, rounded down to a multiple of s
constexpr float kPi = 3.14159265358979323846f;

struct Geometry {
  int s, g, gl, ti, tj, ht, wt;  // scale, blur reach and length, tile in plane and HR pixels
  int lh, lw;                     // luma tile
  int ph, pw;                     // products tile
};

__host__ __device__ inline Geometry geometry(int s, int gl) {
  Geometry q;
  q.s = s;
  q.gl = gl;
  q.g = gl / 2;
  q.ti = q.tj = kTileHR / s > 0 ? kTileHR / s : 1;
  q.ht = s * q.ti;
  q.wt = s * q.tj;
  q.lh = q.ht + 2 * q.g + 2;
  q.lw = q.wt + 2 * q.g + 2;
  q.ph = q.ht + 2 * q.g;
  q.pw = q.wt + 2 * q.g;
  return q;
}

__host__ __device__ inline size_t smem_bytes(const Geometry& q) {
  return sizeof(float) * (static_cast<size_t>(q.lh) * q.lw + 3 * static_cast<size_t>(q.ph) * q.pw +
                          3 * static_cast<size_t>(q.ht) * q.pw);
}

// prm: k1[gl], then nsq strength and ncq coherence quantizers, f32
__global__ void __launch_bounds__(kThreads) raisr_hash_generic_kernel(
    const float* __restrict__ planes, int* __restrict__ out, const float* __restrict__ prm,
    int s, int gl, int nsq, int ncq, int na, int ns, int nc, int hp, int rows, int wq,
    int h2p, int w2p, int tiles_x) {
  extern __shared__ float smem[];
  const Geometry q = geometry(s, gl);
  float* luma = smem;                                   // [lh][lw]
  float* prod = luma + q.lh * q.lw;                     // [3][ph][pw]
  float* vert = prod + 3 * q.ph * q.pw;                 // [3][ht][pw]
  const float* k1 = prm;
  const float* squant = prm + gl;
  const float* cquant = squant + nsq;

  const int n = blockIdx.y;
  const int i0 = (blockIdx.x / tiles_x) * q.ti;  // plane row and column of the tile
  const int j0 = (blockIdx.x % tiles_x) * q.tj;
  const int R0 = s * i0;  // HR row and column of the tile's first output pixel
  const int C0 = s * j0;
  const size_t plane = static_cast<size_t>(rows) * wq;
  const float* img = planes + static_cast<size_t>(n) * s * s * plane;

  // luma of HR rows R0 - g - 1 .. and columns C0 - g - 1 ..; shifted by
  // s*hp >= g + 1 the HR coordinate is never negative, so / and % by s are
  // plane index and phase. Reads past the planes give 0: only outputs that
  // are not written see them.
  for (int e = threadIdx.x; e < q.lh * q.lw; e += kThreads) {
    const int r = e / q.lw;
    const int c = e - r * q.lw;
    const int hr = R0 - q.g - 1 + r + s * hp;
    const int hc = C0 - q.g - 1 + c + s * hp;
    const int pr = hr / s, pc = hc / s;
    float v = 0.0f;
    if (pr < rows && pc < wq) v = img[((hr - pr * s) * s + (hc - pc * s)) * plane + static_cast<size_t>(pr) * wq + pc];
    luma[e] = v;
  }
  __syncthreads();

  // Sobel and the three products of HR rows R0 - g .., columns C0 - g ..
  for (int e = threadIdx.x; e < q.ph * q.pw; e += kThreads) {
    const int r = e / q.pw;
    const int c = e - r * q.pw;
    const float* top = luma + r * q.lw + c;
    const float* mid = top + q.lw;
    const float* bot = mid + q.lw;
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
    prod[e] = gx * gx;
    prod[q.ph * q.pw + e] = gx * gy;
    prod[2 * q.ph * q.pw + e] = gy * gy;
  }
  __syncthreads();

  // vertical pass: HR rows R0 .. R0 + ht - 1, columns C0 - g ..
  for (int e = threadIdx.x; e < 3 * q.ht * q.pw; e += kThreads) {
    const int m = e / (q.ht * q.pw);
    const int rem = e - m * (q.ht * q.pw);
    const int r = rem / q.pw;
    const int c = rem - r * q.pw;
    const float* col = prod + m * q.ph * q.pw + r * q.pw + c;
    float acc = k1[0] * col[0];
    for (int u = 1; u < gl; ++u) acc = acc + k1[u] * col[u * q.pw];
    vert[e] = acc;
  }
  __syncthreads();

  // horizontal pass, eigen analysis and bucket of each HR output pixel;
  // consecutive threads take consecutive plane columns of one phase
  for (int e = threadIdx.x; e < q.ht * q.wt; e += kThreads) {
    const int rr = e / q.wt;
    const int rem = e - rr * q.wt;
    const int b = rem / q.tj;
    const int jj = rem - b * q.tj;
    const int gi = i0 + rr / s;
    const int gj = j0 + jj;
    if (gi >= h2p || gj >= w2p) continue;
    const int c = s * jj + b;  // HR column in the tile
    float st[3];
    for (int m = 0; m < 3; ++m) {
      const float* row = vert + (m * q.ht + rr) * q.pw + c;
      float acc = k1[0] * row[0];
      for (int u = 1; u < gl; ++u) acc = acc + k1[u] * row[u];
      st[m] = acc;
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
    const int p_out = (rr % s) * s + b;
    out[((static_cast<size_t>(n) * s * s + p_out) * h2p + gi) * w2p + gj] = (ai * ns + si) * nc + ci;
  }
}

}  // namespace

// prm: device pointer to the f32 taps (gl of them) followed by nsq strength
// and ncq coherence quantizers (kernels/raisr.hash_params_generic). Planes
// [nimg, s*s, rows, wq] with origin (hp, hp), s * hp >= gl / 2 + 1,
// rows >= h2p + 2 hp, wq >= w2p + 2 hp. Any scale and blur length >= 1.
extern "C" int ocvk_raisr_hash_generic(const float* planes, int* out, const float* prm,
                                       int nimg, int s, int gl, int nsq, int ncq, int na,
                                       int ns, int nc, int hp, int rows, int wq, int h2p,
                                       int w2p, void* stream) {
  if (s < 1 || gl < 1 || nsq < 0 || ncq < 0 || s * hp < gl / 2 + 1 ||
      nimg > 65535 || static_cast<long long>(s) * s * rows * wq >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geometry q = geometry(s, gl);
  const size_t smem = smem_bytes(q);
  if (smem > 227 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      raisr_hash_generic_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_y = (h2p + q.ti - 1) / q.ti;
  const int tiles_x = (w2p + q.tj - 1) / q.tj;
  if (static_cast<long long>(tiles_y) * tiles_x > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(tiles_y * tiles_x, nimg);
  raisr_hash_generic_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      planes, out, prm, s, gl, nsq, ncq, na, ns, nc, hp, rows, wq, h2p, w2p, tiles_x);
  return static_cast<int>(cudaGetLastError());
}
