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
// reference's double count of the seed), 'fixed' the displacement.
//
// What bounds it on the H100: integer operations. Per pixel it reads 2 bytes
// (plus 8 of seed) and writes 8, against (8 n + 1) candidates of ps^2 taps
// for n rounds (25 x 25 taps at 15/5), each a load, a subtract, an absolute
// value or a product, and an add. The frames are small (0.3 MB at VGA) and
// every read lands within sum(steps) + ps/2 pixels of the thread's own, so
// the L1 serves them.
// Design: one thread per pixel, 32 x 8 pixels per block. With ps = 5 the
// frame-0 patch sits in 25 registers; other sizes re-read it through the
// cache. A candidate whose window lies inside the image skips the bounds
// tests. From the second round on the centre candidate's cost is the previous
// round's minimum (the same integer sum), so it is not computed again.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kMaxSteps = 16;

struct Steps {
  int n;
  int s[kMaxSteps];
};

__device__ __forceinline__ int load0(const uint8_t* __restrict__ img, int y, int x, int h, int w) {
  return (y >= 0 && y < h && x >= 0 && x < w) ? static_cast<int>(__ldg(img + y * w + x)) : 0;
}

template <bool SSD>
__device__ __forceinline__ int tap(int a, int b) {
  const int d = a - b;
  return SSD ? d * d : abs(d);
}

// cost of the candidate centred at (cy, cx) in frame 1 for pixel (y, x);
// PS > 0: the frame-0 patch is in `patch`; PS == 0: read it from frame 0
template <int PS, bool SSD>
__device__ __forceinline__ int candidate(const int* patch, const uint8_t* __restrict__ f0,
                                         const uint8_t* __restrict__ f1, int y, int x, int cy,
                                         int cx, int h, int w, int ps_rt) {
  const int ps = PS > 0 ? PS : ps_rt;
  const int pm = ps / 2;
  int sum = 0;
  if (cy - pm >= 0 && cy + pm < h && cx - pm >= 0 && cx + pm < w) {
    const uint8_t* base = f1 + (cy - pm) * w + (cx - pm);
#pragma unroll
    for (int j = 0; j < ps; ++j) {
#pragma unroll
      for (int i = 0; i < ps; ++i) {
        const int a = PS > 0 ? patch[j * ps + i] : load0(f0, y - pm + j, x - pm + i, h, w);
        sum += tap<SSD>(a, static_cast<int>(__ldg(base + j * w + i)));
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < ps; ++j) {
#pragma unroll
      for (int i = 0; i < ps; ++i) {
        const int a = PS > 0 ? patch[j * ps + i] : load0(f0, y - pm + j, x - pm + i, h, w);
        sum += tap<SSD>(a, load0(f1, cy - pm + j, cx - pm + i, h, w));
      }
    }
  }
  return sum;
}

template <int PS, bool SSD>
__global__ void __launch_bounds__(kBlockX* kBlockY)
    me_exact_kernel(const uint8_t* __restrict__ f0, const uint8_t* __restrict__ f1,
                    const float* __restrict__ seed, float* __restrict__ out, int h, int w,
                    int ps_rt, Steps steps, int bound, int shipped) {
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= w || y >= h) return;
  const size_t img = static_cast<size_t>(blockIdx.z) * h * w;
  f0 += img;
  f1 += img;
  const size_t pix = img + static_cast<size_t>(y) * w + x;

  int patch[PS > 0 ? PS * PS : 1];
  if (PS > 0) {
#pragma unroll
    for (int j = 0; j < PS; ++j) {
#pragma unroll
      for (int i = 0; i < PS; ++i) {
        patch[j * PS + i] = load0(f0, y - PS / 2 + j, x - PS / 2 + i, h, w);
      }
    }
  }

  float su = 0.0f, sv = 0.0f;
  int cy = y, cx = x;
  if (seed != nullptr) {
    su = seed[2 * pix];
    sv = seed[2 * pix + 1];
    int by = static_cast<int>(sv);  // truncates toward zero
    int bx = static_cast<int>(su);
    if (bound >= 0) {
      by = min(max(by, -bound), bound);
      bx = min(max(bx, -bound), bound);
    }
    cy += by;
    cx += bx;
  }

  int prev = 0;
  for (int r = 0; r < steps.n; ++r) {
    const int st = steps.s[r];
    int best = INT_MAX, best_k = 0;
    for (int k = 0; k < 9; ++k) {
      int cost;
      if (k == 4 && r > 0) {
        cost = prev;
      } else {
        cost = candidate<PS, SSD>(patch, f0, f1, y, x, cy + (k / 3 - 1) * st,
                                  cx + (k % 3 - 1) * st, h, w, ps_rt);
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

}  // namespace

// steps: host pointer to nsteps ints (at most 16). seed may be null. bound < 0:
// the seed's base is not clamped. shipped != 0: out = seed + displacement.
extern "C" int ocvk_me_exact(const uint8_t* f0, const uint8_t* f1, const float* seed, float* out,
                             const int* steps, int nsteps, int nimg, int h, int w, int ps,
                             int ssd, int bound, int shipped, void* stream) {
  if (nsteps < 0 || nsteps > kMaxSteps || ps < 1 || ps % 2 == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Steps st;
  st.n = nsteps;
  for (int i = 0; i < kMaxSteps; ++i) st.s[i] = i < nsteps ? steps[i] : 0;
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((w + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY, nimg);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ps == 5) {
    if (ssd) {
      me_exact_kernel<5, true><<<grid, block, 0, s>>>(f0, f1, seed, out, h, w, ps, st, bound, shipped);
    } else {
      me_exact_kernel<5, false><<<grid, block, 0, s>>>(f0, f1, seed, out, h, w, ps, st, bound, shipped);
    }
  } else if (ssd) {
    me_exact_kernel<0, true><<<grid, block, 0, s>>>(f0, f1, seed, out, h, w, ps, st, bound, shipped);
  } else {
    me_exact_kernel<0, false><<<grid, block, 0, s>>>(f0, f1, seed, out, h, w, ps, st, bound, shipped);
  }
  return static_cast<int>(cudaGetLastError());
}
