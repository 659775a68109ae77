// RAISR gradient hash in parity-plane space.
//
// Replaces the TPU kernel oclcomputervision_tpu/ops/pallas/raisr_pallas.py,
// hash_planes_pallas (body _make_hash_kernel).
//
// Per HR pixel: Sobel gradients gx, gy of the cheap-upscaled luma; the
// products gx*gx, gx*gy, gy*gy blurred by the separable 9x9 sigma=2 window
// (vertical pass, then horizontal); the eigen analysis of the 2x2 structure
// tensor; and the bucket (angle * ns + strength) * nc + coherence. Same
// expressions in the same order as the plain PyTorch version (the XLA twin
// ops/raisr.hash_planes): the angle comes from atan2f, so buckets differ from
// the plain version's only where an atan2 ULP straddles a boundary. The zero
// vector lands in angle bucket 0 and v = 0, u < 0 in bucket na-1, as there.
// The TPU kernel's symmetric-pair blur, lane rolls and ratio angle test are
// layout tricks for its vector unit and are not carried over.
//
// What bounds it on the H100: ~150 flops (one atan2f, three sqrtf) per HR
// pixel against 4 bytes of luma in and 4 bytes of bucket out, so neither
// memory nor flops dominate at this simple form; the intermediates are what
// would cost: the XLA twin round-trips ~50x the image in f32 through memory.
// Design: one block per full-resolution tile of 32x32 HR pixels (30x30 at
// s=3) of one image. It de-interleaves its luma tile plus the Sobel and blur
// halo (gauss_len/2 + 1 pixels) from the s*s planes into shared memory once;
// the tensor products and the vertical pass stay in shared memory; each
// thread then finishes the horizontal pass and the eigen analysis for its
// pixels and writes int32 buckets in plane layout (coalesced along plane
// columns). Plane-space offsets follow _read_phases: full-res offset (dr, dc)
// of pixel (s*i + a, s*j + b) is plane ((a+dr)%s, (b+dc)%s) at plane offset
// ((a+dr)/s, (b+dc)/s), which the de-interleave resolves once per element.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileHr = 32;  // HR pixels per tile edge (rounded down to s)
constexpr float kPi = 3.14159265358979323846f;

__global__ void __launch_bounds__(kThreads) raisr_hash_kernel(
    const float* __restrict__ planes, int* __restrict__ out,
    const float* __restrict__ k1, const float* __restrict__ squant,
    const float* __restrict__ cquant, int s, int hp, int rows, int wq,
    int h2p, int w2p, int glen, int na, int ns, int nc, int nsq, int ncq,
    int pt) {
  extern __shared__ float smem[];
  const int g = glen / 2;
  const int ft = s * pt;          // HR tile edge
  const int ey = ft + 2 * g + 2;  // luma tile edge (blur + Sobel halo)
  const int et = ft + 2 * g;      // tensor-product tile edge (blur halo)
  float* ys = smem;               // [ey][ey]
  float* ts = ys + ey * ey;       // [3][et][et]
  float* vs = ts + 3 * et * et;   // [3][ft][et]
  const int ss = s * s;
  const int i0 = blockIdx.y * pt;  // plane tile origin
  const int j0 = blockIdx.x * pt;
  const int r0 = s * i0;  // HR tile origin
  const int c0 = s * j0;
  const float* img = planes + static_cast<size_t>(blockIdx.z) * ss * rows * wq;

  // 1. luma tile, de-interleaved: ys[y][x] = up(r0 - g - 1 + y, c0 - g - 1 + x).
  //    R, C are shifted by s*hp >= g + 1, so they are never negative; R / s
  //    is then the plane row index (origin hp included) and R % s the phase.
  for (int e = threadIdx.x; e < ey * ey; e += blockDim.x) {
    const int y = e / ey;
    const int x = e - y * ey;
    const int R = r0 - g - 1 + y + s * hp;
    const int C = c0 - g - 1 + x + s * hp;
    const int pr = R / s;
    const int pc = C / s;
    const int p = (R - pr * s) * s + (C - pc * s);
    ys[e] = (pr < rows && pc < wq)
                ? img[(static_cast<size_t>(p) * rows + pr) * wq + pc]
                : 0.0f;
  }
  __syncthreads();

  // 2. Sobel gradients (taps in row-major order, zeros skipped, as the plain
  //    version's stencil3) and the structure-tensor products.
  const int nt = et * et;
  for (int e = threadIdx.x; e < nt; e += blockDim.x) {
    const int y = e / et;
    const int x = e - y * et;
    const float* q = ys + y * ey + x;  // q[u * ey + v] = Y(R + u - 1, C + v - 1)
    const float y00 = q[0], y01 = q[1], y02 = q[2];
    const float y10 = q[ey], y12 = q[ey + 2];
    const float y20 = q[2 * ey], y21 = q[2 * ey + 1], y22 = q[2 * ey + 2];
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
    ts[e] = gx * gx;
    ts[nt + e] = gx * gy;
    ts[2 * nt + e] = gy * gy;
  }
  __syncthreads();

  // 3. vertical blur: vs[t][y][x] at HR (r0 + y, c0 - g + x)
  for (int e = threadIdx.x; e < ft * et; e += blockDim.x) {
    const int y = e / et;
    const int x = e - y * et;
    for (int t = 0; t < 3; ++t) {
      const float* col = ts + t * nt + y * et + x;
      float acc = k1[0] * col[0];
      for (int u = 1; u < glen; ++u) acc = acc + k1[u] * col[u * et];
      vs[t * ft * et + e] = acc;
    }
  }
  __syncthreads();

  // 4. horizontal blur, eigen analysis and bucket, one plane pixel per step
  const int per_plane = pt * pt;
  for (int e = threadIdx.x; e < ss * per_plane; e += blockDim.x) {
    const int p = e / per_plane;
    const int rem = e - p * per_plane;
    const int ii = rem / pt;
    const int jj = rem - ii * pt;
    const int gi = i0 + ii;
    const int gj = j0 + jj;
    if (gi >= h2p || gj >= w2p) continue;
    const int a = p / s;
    const int b = p - a * s;
    const int y = s * ii + a;
    const int x = s * jj + b;
    float st[3];
    for (int t = 0; t < 3; ++t) {
      const float* row = vs + t * ft * et + y * et + x;
      float acc = k1[0] * row[0];
      for (int u = 1; u < glen; ++u) acc = acc + k1[u] * row[u];
      st[t] = acc;
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
    int si = 0;
    for (int k = 0; k < nsq; ++k) si += l1 >= squant[k];
    int ci = 0;
    for (int k = 0; k < ncq; ++k) ci += coh >= cquant[k];
    out[((static_cast<size_t>(blockIdx.z) * ss + p) * h2p + gi) * w2p + gj] =
        (ai * ns + si) * nc + ci;
  }
}

}  // namespace

extern "C" int ocvk_raisr_hash(const float* planes, int* out, const float* k1,
                               const float* squant, const float* cquant,
                               int nimg, int s, int hp, int rows, int wq,
                               int h2p, int w2p, int glen, int na, int ns,
                               int nc, int nsq, int ncq, void* stream) {
  const int pt = kTileHr / s;  // plane pixels per tile edge
  if (pt < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int g = glen / 2;
  const int ft = s * pt;
  const int ey = ft + 2 * g + 2;
  const int et = ft + 2 * g;
  const size_t smem = sizeof(float) * (ey * ey + 3 * et * et + 3 * ft * et);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        raisr_hash_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((w2p + pt - 1) / pt, (h2p + pt - 1) / pt, nimg);
  raisr_hash_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      planes, out, k1, squant, cquant, s, hp, rows, wq, h2p, w2p, glen, na,
      ns, nc, nsq, ncq, pt);
  return static_cast<int>(cudaGetLastError());
}
