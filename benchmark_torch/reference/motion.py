"""Plain PyTorch hybrid block-matching pyramid of uint8 frame pairs.

Dense optical flow as upstream ``motion_estimation/me_pyramid.py:130-205``
and ``me_test.py:51-90`` define it, with the hybrid schedule and the
subpixel rounds of the port's ``estimate_motion_pyramid(method='fast',
smooth=k, subpixel=n)`` as its docstrings describe them, written from that
description and independent of the program under test. A flow is float32
[B, H, W, 2], (u, v) = (x, y) displacement from frame 0 to frame 1.

- Levels: ``reference/pyramid.py`` of each frame, coarsest first.
- The exact search: for every pixel p the patch x patch patch of frame 0
  around p, both frames zero outside the image; a centre c (p, or p plus
  the seed's base in the seeded form); for each step of the schedule
  (search // 2 - patch // 2, halved while at least 1: 5, 2, 1 at 15 / 5)
  the sum of absolute differences (SAD) against frame 1's patch at c +
  (oy, ox) for the 3 x 3 grid (oy, ox) in {-step, 0, step}^2, the first
  least in row-major (oy, ox) order, and c moved there. The flow is c - p.
  Seeded ('fixed' seed mode): the base is trunc(seed) toward zero, clamped
  to [-bound, bound].
- The fast iteration: a state (dy, dx) from zero; each step warps frame 1
  by the state (w(p) = f1(p + state(p)), zero outside), costs each
  candidate (oy, ox) in {-step, 0, step}^2 as the zero-padded patch sum of
  |f0(q) - w(q + (oy, ox))| (w zero outside), moves the state by the
  first least, then takes the 3 x 3 median of both state planes, edges
  replicated. Around a seed ('auto' warp bound) frame 1 is first warped by
  the unclamped base trunc(seed); the flow is the base plus the state.
- The median of k x k: per plane, edges replicated.
- The subpixel fit: (iu, iv) the flow rounded half to even; five SAD costs
  at (iv, iu) + {(0, 0), (0, -1), (0, 1), (-1, 0), (1, 0)}, each the
  zero-padded patch sum of |f0(q) - f1(q + (iv, iu)(q) + offset)| (every
  pixel of a patch at its own displacement), in float32; per axis the
  equiangular fit d = (c- - c+) / (2 (max(c-, c+) - c0)) (the denominator
  at least 1e-12), 0 unless c0 is no larger than both neighbours, clamped
  to [-0.5, 0.5]; the flow is (iu + du, iv + dv).
- The seed of the next level ('fixed' seed mode): each flow plane resized
  x 2 with half-pixel bilinear taps (cv2.INTER_LINEAR: source coordinate
  (i + 0.5) n_in / n_out - 0.5, its weight 0 below the first pixel and 1
  past the last), rows then columns, each output w0 a0 + w1 a1, times 2.
- The hybrid schedule: the coarsest level by the unseeded exact search;
  every later level by the fast iteration around the seed, then the k x k
  median, a bound from {8, 12, 16, 20, 24, 32} (the least that holds the
  largest |trunc| of the smoothed flow, else 32), the smoothed flow
  clipped to it, and one seeded exact search around it with that bound;
  then, at every level, n rounds of (subpixel fit, k x k median).

Departures from the published description, each without effect on the
flow: SAD is summed in int32 (upstream: float32 of uint8 differences, the
same whole numbers); only the 'fixed' seed mode is written (upstream's
'shipped' mode counts the seed's integer part twice); the bound of the
seeded pass is sized per block of pairs, not per call, which gives the
same flow, since trunc of the clipped seed is trunc of the seed wherever
that fits the bound and is the bound wherever it does not, and the bound
is 32 whenever it does not.

``fit_dtype`` and ``upscale_dtype`` compute the subpixel fit (costs and
fit) and the seed upscale in another precision, for the control; float32
is as stated. TF32 is off while the reference runs.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from benchmark_torch.reference import pyramid as ref_pyramid

BOUNDS = (8, 12, 16, 20, 24, 32)  # the seeded pass's bounds, least first
MIN_DENOMINATOR = 1e-12  # the equiangular fit's least denominator
AXIS_OFFSETS = ((0, 0), (0, -1), (0, 1), (-1, 0), (1, 0))  # the fit's five costs (dy, dx)


@contextlib.contextmanager
def no_tf32():
    """float32 products as float32 on the card while the reference runs."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def steps(search: int, patch: int) -> list:
    """The step schedule: search // 2 - patch // 2, halved while >= 1."""
    out, s = [], search // 2 - patch // 2
    while s >= 1:
        out.append(s)
        s //= 2
    return out


def _pixels(like: torch.Tensor):
    """Row and column indices [H, 1] and [1, W] of [..., H, W] ``like``."""
    h, w = like.shape[-2:]
    return (torch.arange(h, device=like.device)[:, None],
            torch.arange(w, device=like.device)[None, :])


def fetch(img: torch.Tensor, yy: torch.Tensor, xx: torch.Tensor) -> torch.Tensor:
    """img[n, yy, xx] as int32, 0 where (yy, xx) is outside the image:
    ``img`` [B, H, W], integer ``yy``, ``xx`` of shape [..., B, H, W]."""
    b, h, w = img.shape
    inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
    n = torch.arange(b, device=img.device)[:, None, None]
    flat = (n * h + yy.clamp(0, h - 1)) * w + xx.clamp(0, w - 1)
    return torch.where(inside, img.reshape(-1)[flat].to(torch.int32), 0)


def shifted(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """img at (y + dy, x + dx), zero outside: [..., H, W]."""
    h, w = img.shape[-2:]
    r = max(abs(dy), abs(dx))
    pad = F.pad(img, (r, r, r, r))
    return pad[..., r + dy : r + dy + h, r + dx : r + dx + w]


def patch_sum(d: torch.Tensor, patch: int) -> torch.Tensor:
    """The patch x patch sum around each pixel of [B, H, W] ``d``, zero
    outside the image."""
    m = patch // 2
    return sum(shifted(d, i, j) for i in range(-m, m + 1) for j in range(-m, m + 1))


def exact(f0, f1, search: int, patch: int, seed=None, bound=None) -> torch.Tensor:
    """The exact search of uint8 [B, H, W] frames, unseeded or around the
    clamped base of a float32 [B, H, W, 2] ``seed``; float32 [B, H, W, 2]."""
    ys, xs = _pixels(f0)
    cy = ys.expand(f0.shape).clone()
    cx = xs.expand(f0.shape).clone()
    if seed is not None:
        by, bx = torch.trunc(seed[..., 1]).long(), torch.trunc(seed[..., 0]).long()
        if bound is not None:
            by, bx = by.clamp(-bound, bound), bx.clamp(-bound, bound)
        cy, cx = cy + by, cx + bx
    m = patch // 2
    offs = torch.arange(-m, m + 1, device=f0.device)
    oy = offs.repeat_interleave(patch)[:, None, None, None]  # [patch^2, 1, 1, 1], row-major
    ox = offs.repeat(patch)[:, None, None, None]
    p0 = fetch(f0, ys + oy, xs + ox)  # [patch^2, B, H, W]
    for s in steps(search, patch):
        costs = torch.stack([(p0 - fetch(f1, cy + gy + oy, cx + gx + ox)).abs().sum(0)
                             for gy in (-s, 0, s) for gx in (-s, 0, s)])
        k = costs.argmin(0)  # the first least
        cy, cx = cy + (k // 3 - 1) * s, cx + (k % 3 - 1) * s
    return torch.stack([cx - xs, cy - ys], -1).to(torch.float32)


def median(planes: torch.Tensor, k: int) -> torch.Tensor:
    """The k x k median of each [H, W] plane of [..., H, W], edges
    replicated (k odd)."""
    h, w = planes.shape[-2:]
    r = k // 2
    rows = torch.arange(-r, h + r, device=planes.device).clamp(0, h - 1)
    cols = torch.arange(-r, w + r, device=planes.device).clamp(0, w - 1)
    pad = planes[..., rows, :][..., cols]
    win = torch.stack([pad[..., i : i + h, j : j + w] for i in range(k) for j in range(k)], -1)
    return win.median(-1).values


def median_flow(flow: torch.Tensor, k: int) -> torch.Tensor:
    """The k x k median of both planes of a [B, H, W, 2] flow."""
    return median(flow.movedim(-1, 1), k).movedim(1, -1).contiguous()


def fast(f0, f1, search: int, patch: int, seed=None) -> torch.Tensor:
    """The fast iteration of uint8 [B, H, W] frames, around the base of a
    float32 [B, H, W, 2] ``seed`` if given; float32 [B, H, W, 2]."""
    ys, xs = _pixels(f0)
    by = bx = torch.zeros(f0.shape, dtype=torch.long, device=f0.device)
    if seed is not None:
        by, bx = torch.trunc(seed[..., 1]).long(), torch.trunc(seed[..., 0]).long()
        f1 = fetch(f1, ys + by, xs + bx)
    a = f0.to(torch.int32)
    dy = dx = torch.zeros(f0.shape, dtype=torch.long, device=f0.device)
    for s in steps(search, patch):
        warped = fetch(f1, ys + dy, xs + dx)
        costs = torch.stack([patch_sum((a - shifted(warped, gy, gx)).abs(), patch)
                             for gy in (-s, 0, s) for gx in (-s, 0, s)])
        k = costs.argmin(0)
        dy, dx = median(dy + (k // 3 - 1) * s, 3), median(dx + (k % 3 - 1) * s, 3)
    return torch.stack([bx + dx, by + dy], -1).to(torch.float32)


def bound_for(flow: torch.Tensor) -> int:
    """The least of ``BOUNDS`` at or above the largest |trunc| of ``flow``,
    else the largest."""
    top = torch.trunc(flow).abs().max().item()
    return next((b for b in BOUNDS if top <= b), BOUNDS[-1])


def fit(f0, f1, flow, patch: int, dtype=torch.float32) -> torch.Tensor:
    """One subpixel fit of a float32 [B, H, W, 2] flow, in ``dtype``."""
    ys, xs = _pixels(f0)
    iu, iv = torch.round(flow[..., 0]).long(), torch.round(flow[..., 1]).long()
    a = f0.to(torch.int32)
    c0, cxm, cxp, cym, cyp = (
        patch_sum((a - fetch(f1, ys + iv + oy, xs + iu + ox)).abs(), patch).to(dtype)
        for oy, ox in AXIS_OFFSETS)

    def axis(cm, cp):
        d = (cm - cp) / torch.clamp(2 * (torch.maximum(cm, cp) - c0), min=MIN_DENOMINATOR)
        return torch.clamp(torch.where((cm >= c0) & (cp >= c0), d, 0), -0.5, 0.5)

    u = iu.to(dtype) + axis(cxm, cxp)
    v = iv.to(dtype) + axis(cym, cyp)
    return torch.stack([u, v], -1).to(torch.float32)


def halfpixel_taps(n_out: int, n_in: int, device):
    """cv2.INTER_LINEAR taps of one axis: i0, i1 [n_out] and float64
    weights w0, w1 [n_out]."""
    x = (torch.arange(n_out, dtype=torch.float64, device=device) + 0.5) * (n_in / n_out) - 0.5
    i0 = torch.floor(x)
    u = x - i0
    u = torch.where(i0 < 0, 0.0, torch.where(i0 >= n_in - 1, 1.0, u))
    i0 = i0.long().clamp(0, n_in - 1)
    return i0, (i0 + 1).clamp(0, n_in - 1), 1 - u, u


def upscale(flow: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """The x 2 'fixed' seed of a float32 [B, h, w, 2] flow, in ``dtype``:
    [B, 2h, 2w, 2] float32."""
    planes = flow.movedim(-1, 1).to(dtype)  # [B, 2, h, w]
    h, w = planes.shape[-2:]
    y0, y1, vy0, vy1 = halfpixel_taps(2 * h, h, flow.device)
    x0, x1, ux0, ux1 = halfpixel_taps(2 * w, w, flow.device)
    rows = planes[..., y0, :] * vy0.to(dtype)[:, None] + planes[..., y1, :] * vy1.to(dtype)[:, None]
    out = rows[..., x0] * ux0.to(dtype) + rows[..., x1] * ux1.to(dtype)
    return (out * 2).to(torch.float32).movedim(1, -1).contiguous()


def hybrid(x: torch.Tensor, spec: dict, fit_dtype=torch.float32,
           upscale_dtype=torch.float32) -> list:
    """The flows of uint8 [B, 2, H, W] pairs under the configuration
    ``spec`` (levels, search_size, patch_size, smooth, subpixel): float32
    [B, h, w, 2] per level, coarsest first."""
    search, patch, k = spec["search_size"], spec["patch_size"], spec["smooth"]
    with no_tf32():
        pyr0 = ref_pyramid.pyramid(x[:, 0].contiguous(), spec["levels"])
        pyr1 = ref_pyramid.pyramid(x[:, 1].contiguous(), spec["levels"])
        flows, seed = [], None
        for lv, (f0, f1) in enumerate(zip(pyr0, pyr1)):
            if seed is None:
                flow = exact(f0, f1, search, patch)
            else:
                smoothed = median_flow(fast(f0, f1, search, patch, seed), k)
                b = bound_for(smoothed)
                flow = exact(f0, f1, search, patch, smoothed.clamp(-b, b), b)
            for _ in range(spec["subpixel"]):
                flow = median_flow(fit(f0, f1, flow, patch, fit_dtype), k)
            flows.append(flow)
            if lv + 1 < len(pyr0):
                seed = upscale(flow, upscale_dtype)
    return flows
