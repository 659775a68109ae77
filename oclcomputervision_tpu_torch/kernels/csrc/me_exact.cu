// Exact shrinking-step block matching, unseeded and seeded: per pixel, the
// ps x ps patch of frame 0 (zero outside the image) is matched in frame 1
// (zero outside the image) by rounds of 3x3 candidates at {-step, 0, +step}
// around the current centre, integer SAD or SSD, first minimum in row-major
// (dy, dx) order, recentre. f0, f1 [B, H, W] uint8 and an optional seed
// [B, H, W, 2] float32 (u = x, v = y) -> out [B, H, W, 2] float32,
// integer-valued displacements.
//
// Replaces two TPU kernels of oclcomputervision_tpu/ops/pallas/me_pallas.py:
// me_exact_pallas (body _make_me_kernel) and _seeded_impl (body
// _make_me_seeded_kernel). Both avoid per-pixel reads, which the TPU has
// none of: they build one cost map per reachable displacement from rotated
// copies of a 32-row band and pick each pixel's candidates with masks over
// the reachable set, which is why the seeded one needs the seed clamped to
// [-B, B]. Here a thread reads where its pixel's centre points, so one
// kernel serves both and the clamp is kept only because it is part of what
// the search returns for a seed beyond B (bound < 0: no clamp).
//
// Semantics: oracle/motion.estimate_motion_vector. The centre starts at
// p + clamp(trunc(seed)); 'shipped' returns seed + displacement (the
// reference's double count of the seed), 'fixed' the displacement. From the
// second round on the centre candidate's cost is the previous round's
// minimum (the same integer sum), so it is not computed again.
//
// What bounds it on the H100: the candidate costs, (8 n + 1) candidates of
// ps^2 taps per pixel for n rounds (25 x 25 taps at 15/5), against 2 bytes
// read (plus 8 of seed) and 8 written. The first form spent a one-byte
// load, its address, a subtract, an absolute value and an add on every tap,
// with a bounds test per tap near the edges: 0.5224 ms unseeded at
// 8 x 480 x 640 and 0.3277 ms seeded (bound 32) at 4 x 480 x 640, 7.6x and
// 9.5x the operation bound. This form: 0.1964 and 0.1071 ms (NVIDIA H100
// 80GB HBM3, 700 W power limit, chip_smoke.py).
// Design:
//  - A block of 32 x 8 pixels stages its frame-0 tile (plus the patch reach)
//    and the frame-1 window its candidates can reach in shared memory, zero
//    outside the image, so no tap tests its position. The window is the
//    block's own: the tile grown by the spread of its pixels' seed bases
//    (each thread's clamped base, reduced by shared-memory atomics) and by
//    ps/2 + sum(steps). The host reserves room for the window a bound allows
//    (kernels/motion.me_window_bytes); a block whose window does not fit,
//    as with far seeds and no bound, reads frame 1 through L1 with a bounds
//    test per tap instead, inside the same kernel.
//  - Staging reads frame bytes one at a time, so no read from device memory
//    passes the last byte of a row or of the allocation, whatever W is; the
//    32-bit words below are read only from shared memory, whose rows are
//    padded by 8 bytes.
//  - Four bytes per instruction: a candidate row of ps bytes at any
//    alignment comes from 32-bit words of the window by __funnelshift_r
//    (its last byte at ps = 5 by one __byte_perm), and __vsadu4 (one
//    VABSDIFF4.ACC on sm_90a) adds four absolute differences to the sum;
//    SSD takes them by __vabsdiffu4 (VABSDIFF4) and dots them with
//    themselves by __dp4a (IDP.4A). The frame-0 side of a row's last word is
//    masked to the patch. The integer sums equal the plain version's. With
//    ps = 5 the frame-0 patch sits in 10 registers as words; other sizes
//    read it from the staged tile.
//  - What bounds it now: shared-memory loads, two words per candidate row
//    (a third for the fifth byte, and __vabsdiffu4 + __dp4a for SAD, took
//    0.2509 / 0.1580 ms), and their bank conflicts once a warp's pixels have
//    moved apart. One byte load per tap from the staged window took 0.3314
//    / 0.2034 ms.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kMaxSteps = 16;
constexpr int kRowPad = 8;  // bytes past a staged row that word reads may touch

struct Steps {
  int n;
  int sum;
  int s[kMaxSteps];
};

__host__ __device__ constexpr int row_stride(int cols) { return ((cols + 3) & ~3) + kRowPad; }

__device__ __forceinline__ int load0(const uint8_t* __restrict__ img, int y, int x, int h, int w) {
  return (y >= 0 && y < h && x >= 0 && x < w) ? static_cast<int>(__ldg(img + y * w + x)) : 0;
}

// the four bytes at byte offset c of a 4-byte-aligned row
__device__ __forceinline__ uint32_t bytes4(const uint8_t* row, int c) {
  const uint32_t* p = reinterpret_cast<const uint32_t*>(row) + (c >> 2);
  return __funnelshift_r(p[0], p[1], (c & 3) * 8);
}

// bytes [0, nb) of a patch row's last word kept, the rest zeroed
__device__ __forceinline__ uint32_t keep_bytes(uint32_t v, int nb) {
  return v & (0xffffffffu >> (8 * (4 - nb)));
}

// cost from the staged window: the candidate patch's top-left byte is at
// window row r, column c; PS > 0: the frame-0 patch words are in `pa` (the
// last word of each row masked to the patch), PS == 0: read them from the
// frame-0 tile at (ty, tx). SAD: __vsadu4 (one VABSDIFF4.ACC); SSD: the
// absolute differences dotted with themselves by __dp4a.
template <int PS, bool SSD>
__device__ __forceinline__ int cost_staged(const uint32_t* pa, const uint8_t* t0, int stride0,
                                           int ty, int tx, const uint8_t* win, int stride, int r,
                                           int c, int ps_rt) {
  const int ps = PS > 0 ? PS : ps_rt;
  const int nw = (ps + 3) / 4;
  const int last = ps - 4 * (nw - 1);  // bytes of the last word in the patch
  const int sh = (c & 3) * 8;
  uint32_t sum = 0;
#pragma unroll
  for (int j = 0; j < ps; ++j) {
    const uint32_t* p = reinterpret_cast<const uint32_t*>(win + (r + j) * stride) + (c >> 2);
#pragma unroll
    for (int q = 0; q < nw; ++q) {
      uint32_t a = PS > 0 ? pa[j * ((PS + 3) / 4) + q] : bytes4(t0 + (ty + j) * stride0, tx + 4 * q);
      uint32_t b;
      if (q < nw - 1) {
        b = __funnelshift_r(p[q], p[q + 1], sh);
      } else if (last == 1) {  // one byte, all in word q: byte (c & 3) of it
        b = __byte_perm(p[q], 0u, 0x4440u | static_cast<uint32_t>(c & 3));
        if (PS == 0) a = keep_bytes(a, 1);
      } else {
        b = keep_bytes(__funnelshift_r(p[q], p[q + 1], sh), last);
        if (PS == 0) a = keep_bytes(a, last);
      }
      if (SSD) {
        const uint32_t d = __vabsdiffu4(a, b);
        sum = __dp4a(d, d, sum);
      } else {
        sum += __vsadu4(a, b);
      }
    }
  }
  return static_cast<int>(sum);
}

// cost read from device memory with a bounds test per tap (a block whose
// window does not fit in shared memory)
template <int PS, bool SSD>
__device__ __forceinline__ int cost_global(const uint8_t* __restrict__ f0,
                                           const uint8_t* __restrict__ f1, int y, int x, int cy,
                                           int cx, int h, int w, int ps_rt) {
  const int ps = PS > 0 ? PS : ps_rt;
  const int pm = ps / 2;
  int sum = 0;
  for (int j = 0; j < ps; ++j) {
    for (int i = 0; i < ps; ++i) {
      const int d = load0(f0, y - pm + j, x - pm + i, h, w) - load0(f1, cy - pm + j, cx - pm + i, h, w);
      sum += SSD ? d * d : abs(d);
    }
  }
  return sum;
}

template <int PS, bool SSD>
__global__ void __launch_bounds__(kBlockX* kBlockY)
    me_exact_kernel(const uint8_t* __restrict__ f0, const uint8_t* __restrict__ f1,
                    const float* __restrict__ seed, float* __restrict__ out, int h, int w,
                    int ps_rt, Steps steps, int bound, int shipped, int win_cap) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int ext[4];  // min, max of the seed bases' rows and columns
  const int ps = PS > 0 ? PS : ps_rt;
  const int pm = ps / 2;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kBlockX + tx;
  const int x0 = blockIdx.x * kBlockX, y0 = blockIdx.y * kBlockY;
  const int x = x0 + tx, y = y0 + ty;
  const bool active = x < w && y < h;
  const size_t img = static_cast<size_t>(blockIdx.z) * h * w;
  f0 += img;
  f1 += img;
  const size_t pix = img + static_cast<size_t>(y) * w + x;

  float su = 0.0f, sv = 0.0f;
  int by = 0, bx = 0;
  if (seed != nullptr && active) {
    su = seed[2 * pix];
    sv = seed[2 * pix + 1];
    by = static_cast<int>(sv);  // truncates toward zero
    bx = static_cast<int>(su);
    if (bound >= 0) {
      by = min(max(by, -bound), bound);
      bx = min(max(bx, -bound), bound);
    }
  }
  if (tid == 0) {
    ext[0] = INT_MAX;
    ext[1] = INT_MIN;
    ext[2] = INT_MAX;
    ext[3] = INT_MIN;
  }
  __syncthreads();
  if (active) {
    atomicMin(&ext[0], by);
    atomicMax(&ext[1], by);
    atomicMin(&ext[2], bx);
    atomicMax(&ext[3], bx);
  }
  __syncthreads();

  // frame-0 tile: image rows y0 - pm .., columns x0 - pm ..
  const int rows0 = kBlockY + 2 * pm, cols0 = kBlockX + 2 * pm;
  const int stride0 = row_stride(cols0);
  uint8_t* t0 = smem;
  // frame-1 window: every candidate patch of the block's pixels
  const int reach = pm + steps.sum;
  const long long wy0 = static_cast<long long>(y0) + ext[0] - reach;
  const long long wx0 = static_cast<long long>(x0) + ext[2] - reach;
  const long long wrows = static_cast<long long>(kBlockY) + ext[1] - ext[0] + 2 * reach;
  const long long wcols = static_cast<long long>(kBlockX) + ext[3] - ext[2] + 2 * reach;
  const bool staged = wcols <= win_cap && wrows * row_stride(static_cast<int>(wcols)) <= win_cap;
  const int stride = staged ? row_stride(static_cast<int>(wcols)) : 0;
  uint8_t* win = smem + ((rows0 * stride0 + 15) & ~15);

  for (int r = ty; r < rows0; r += kBlockY) {
    for (int c = tx; c < cols0; c += kBlockX) {
      t0[r * stride0 + c] = static_cast<uint8_t>(load0(f0, y0 - pm + r, x0 - pm + c, h, w));
    }
  }
  if (staged) {
    const int nr = static_cast<int>(wrows), nc = static_cast<int>(wcols);
    const int iy0 = static_cast<int>(wy0), ix0 = static_cast<int>(wx0);
    for (int r = ty; r < nr; r += kBlockY) {
      for (int c = tx; c < nc; c += kBlockX) {
        win[r * stride + c] = static_cast<uint8_t>(load0(f1, iy0 + r, ix0 + c, h, w));
      }
    }
  }
  __syncthreads();
  if (!active) return;

  constexpr int kWords = PS > 0 ? PS * ((PS + 3) / 4) : 1;
  uint32_t pa[kWords];
  if (PS > 0) {
#pragma unroll
    for (int j = 0; j < PS; ++j) {
#pragma unroll
      for (int q = 0; q < (PS + 3) / 4; ++q) {
        const uint32_t v = bytes4(t0 + (ty + j) * stride0, tx + 4 * q);
        pa[j * ((PS + 3) / 4) + q] = q < (PS + 3) / 4 - 1 ? v : keep_bytes(v, PS - 4 * ((PS + 3) / 4 - 1));
      }
    }
  }

  int cy = y + by, cx = x + bx;
  int prev = 0;
  for (int r = 0; r < steps.n; ++r) {
    const int st = steps.s[r];
    int best = INT_MAX, best_k = 0;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      int cost;
      const int qy = cy + (k / 3 - 1) * st, qx = cx + (k % 3 - 1) * st;
      if (k == 4 && r > 0) {
        cost = prev;
      } else if (staged) {
        cost = cost_staged<PS, SSD>(pa, t0, stride0, ty, tx, win, stride,
                                    qy - pm - static_cast<int>(wy0), qx - pm - static_cast<int>(wx0), ps);
      } else {
        cost = cost_global<PS, SSD>(f0, f1, y, x, qy, qx, h, w, ps);
      }
      if (cost < best) {  // strict: the first minimum in (dy, dx) order wins
        best = cost;
        best_k = k;
      }
    }
    cy += (best_k / 3 - 1) * st;
    cx += (best_k % 3 - 1) * st;
    prev = best;
  }

  const float du = static_cast<float>(cx - x);
  const float dv = static_cast<float>(cy - y);
  out[2 * pix] = shipped ? su + du : du;
  out[2 * pix + 1] = shipped ? sv + dv : dv;
}

template <int PS, bool SSD>
cudaError_t launch(const uint8_t* f0, const uint8_t* f1, const float* seed, float* out,
                   const Steps& st, int nimg, int h, int w, int ps, int bound, int shipped,
                   int win_cap, cudaStream_t stream) {
  const int pm = ps / 2;
  const int smem = ((((kBlockY + 2 * pm) * row_stride(kBlockX + 2 * pm)) + 15) & ~15) + win_cap;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        me_exact_kernel<PS, SSD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((w + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY, nimg);
  me_exact_kernel<PS, SSD><<<grid, block, smem, stream>>>(f0, f1, seed, out, h, w, ps, st, bound,
                                                          shipped, win_cap);
  return cudaGetLastError();
}

}  // namespace

// steps: host pointer to nsteps ints (at most 16). seed may be null. bound < 0:
// the seed's base is not clamped. shipped != 0: out = seed + displacement.
// win_cap: shared-memory bytes reserved for a block's frame-1 window.
extern "C" int ocvk_me_exact(const uint8_t* f0, const uint8_t* f1, const float* seed, float* out,
                             const int* steps, int nsteps, int nimg, int h, int w, int ps,
                             int ssd, int bound, int shipped, int win_cap, void* stream) {
  if (nsteps < 0 || nsteps > kMaxSteps || ps < 1 || ps % 2 == 0 || win_cap < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Steps st;
  st.n = nsteps;
  st.sum = 0;
  for (int i = 0; i < kMaxSteps; ++i) {
    st.s[i] = i < nsteps ? steps[i] : 0;
    st.sum += st.s[i];
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (ps == 5) {
    err = ssd ? launch<5, true>(f0, f1, seed, out, st, nimg, h, w, ps, bound, shipped, win_cap, s)
              : launch<5, false>(f0, f1, seed, out, st, nimg, h, w, ps, bound, shipped, win_cap, s);
  } else {
    err = ssd ? launch<0, true>(f0, f1, seed, out, st, nimg, h, w, ps, bound, shipped, win_cap, s)
              : launch<0, false>(f0, f1, seed, out, st, nimg, h, w, ps, bound, shipped, win_cap, s);
  }
  return static_cast<int>(err);
}
