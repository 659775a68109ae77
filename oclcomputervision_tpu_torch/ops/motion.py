"""Pyramidal dense block-matching motion estimation in PyTorch.

Port of ``oclcomputervision_tpu/ops/motion.py`` with its Pallas paths
(``ops/pallas/me_pallas.py``, ``me_fast_pallas.py``):

- ``estimate_motion_vector``: one level. ``method='exact'`` is the
  reference's shrinking-step search (``kernels.motion.me_exact_kernel``,
  unseeded and seeded); ``method='fast'`` the warp-based iteration
  (``kernels.motion.me_fast_kernel``) around a seed base that is
  gather-warped once.
- ``estimate_motion_pyramid``: the coarse-to-fine loop over
  ``ops.pyramid.gaussian_pyramid``, with median smoothing
  (``median_filter_flow``), seed upscaling (``upscale_mv``), subpixel rounds
  (``refine_flow_subpixel``) and the hybrid fast + seeded-exact schedule.

Under a profiler a pyramid call is the span ``ocv.motion`` of
``utils.tracing``, with its stages inside: ``ocv.pyramid`` (both Gaussian
pyramids), ``ocv.motion.exact`` (an exact search; a refinement's bound
sizing and clip with it), ``ocv.motion.fast`` (the fast iteration with its
seed-base gather), ``ocv.motion.median`` (each ``median_filter_flow``),
``ocv.motion.subpixel`` (each subpixel fit) and ``ocv.motion.upscale``
(each ``upscale_mv``).

Numpy inputs run on the card unless ``device="cpu"`` is passed; a torch
tensor runs on its own device (the CUDA kernels for a CUDA tensor, their
plain versions for a CPU tensor). Frames are uint8 [H, W] or batch-first
[B, H, W]; flows are float32 [..., H, W, 2] (u = x, v = y) tensors.

Semantics (zero-padded windows, first-minimum tie-breaking in row-major
(dy, dx) order, the 'shipped' seed double count) match ``oracle/motion.py``.
The searches are integer and equal the JAX package's bit for bit. Two
meanings differ from it on purpose: ``warp_bound='auto'`` is the residual
form on every device (the JAX package takes it on the TPU only), and
``exact_flow_bound`` follows the step schedule.

Left on the TPU side: band heights, VMEM budgets and fallbacks, per-band seed
rebasing and its host statistics, the XLA S-map formulations and their size
gates (one layout of the same search), and any jit-versus-eager distinction.
"""

from __future__ import annotations

import warnings
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from oclcomputervision_tpu_torch._device import as_tensor
from oclcomputervision_tpu_torch.kernels import motion as kmotion
from oclcomputervision_tpu_torch.ops._layout import guard_batch_first
from oclcomputervision_tpu_torch.ops.pyramid import gaussian_pyramid
from oclcomputervision_tpu_torch.oracle.motion import me_steps
from oclcomputervision_tpu_torch.utils import tracing

SEED_BOUND_QUANTA = (8, 12, 16, 20, 24, 32)


class Stages(NamedTuple):
    """The two kernel stages the motion ops run."""

    exact: Callable
    fast: Callable


# the kernel wrappers (plain versions for CPU tensors, kernels for CUDA ones)
KERNEL_STAGES = Stages(kmotion.me_exact_kernel, kmotion.me_fast_kernel)
# the plain PyTorch versions on any device (the kernels' reference on the card)
PLAIN_STAGES = Stages(kmotion.me_exact, kmotion.me_fast)


def _frames(gray0, gray1, device, op: str):
    """Two uint8 frames [H, W] or batch-first [B, H, W] -> ([B, H, W] each,
    whether the input was one pair)."""
    g0 = as_tensor(gray0, device)
    g1 = as_tensor(gray1, g0.device)
    if g0.dtype != torch.uint8 or g1.dtype != torch.uint8:
        raise TypeError(f"{op} expects uint8 frames, got {g0.dtype} and {g1.dtype}")
    if g0.shape != g1.shape:
        raise ValueError(f"{op}: frames differ, {tuple(g0.shape)} vs {tuple(g1.shape)}")
    if g0.ndim == 3:
        guard_batch_first(g0.shape, op)
    elif g0.ndim != 2:
        raise ValueError(f"{op} takes [H, W] or [B, H, W], got {tuple(g0.shape)}")
    single = g0.ndim == 2
    if single:
        g0, g1 = g0[None], g1[None]
    return g0.contiguous(), g1.contiguous(), single


def _flow(mv, device, like: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A float32 flow tensor [..., H, W, 2] on ``like``'s device (or by
    ``as_tensor``'s rule)."""
    t = as_tensor(mv, device if like is None else like.device).to(torch.float32)
    if t.ndim not in (3, 4) or t.shape[-1] != 2:
        raise ValueError(f"flow must be [H, W, 2] or [B, H, W, 2], got {tuple(t.shape)}")
    return t


def exact_halo_rows(search_size: int = 15, patch_size: int = 5) -> int:
    """Per-side row halo that makes a band-local EXACT search exact: every
    output pixel reads frame rows within pm (patch) + sum(steps) (the
    largest reachable displacement) of itself and nothing else (10 rows at
    15/5)."""
    return patch_size // 2 + sum(me_steps(search_size, patch_size))


def fast_halo_rows(search_size: int = 15, patch_size: int = 5) -> int:
    """Per-side row halo that makes a band-local fast iteration exact: each
    round spreads state influence by 1 (median) + step (candidate shift) +
    pm (patch sum) rows."""
    pm = patch_size // 2
    return sum(1 + st + pm for st in me_steps(search_size, patch_size))


def _fast_residual_band(
    f0_ext: torch.Tensor,
    f1_ext: torch.Tensor,
    r0: int,
    h: int,
    w: int,
    search_size: int = 15,
    patch_size: int = 5,
    costfn: str = "sad",
) -> torch.Tensor:
    """The fast residual iteration on a row band (``ops/motion.py:643`` of
    the JAX package): ``f0_ext`` / ``f1_ext`` uint8 [S, w] hold global rows
    [r0, r0 + S) of frame 0 and the (seed-base-warped) frame 1 of an
    [h, w] image; ``r0`` may be negative. Returns float32 [S, w, 2] (u = dx,
    v = dy) whose rows at distance >= ``fast_halo_rows()`` from both band
    edges equal the whole image's.

    The band is cut to its rows inside the image, [max(0, -r0),
    min(S, h - r0)), and the ordinary fast iteration (the round and median
    kernels) runs on that: a band edge that is the image's edge then has the
    whole image's edge semantics (zero warp and box-sum padding, a
    replicated median) exactly, and what an interior edge gets wrong stays
    within the halo. Rows outside the image are zero.
    """
    if f0_ext.dtype != torch.uint8 or f0_ext.ndim != 2 or f0_ext.shape[1] != w:
        raise ValueError(f"bands must be uint8 [S, {w}], got {f0_ext.dtype} {tuple(f0_ext.shape)}")
    if f1_ext.shape != f0_ext.shape:
        raise ValueError(f"bands differ: {tuple(f0_ext.shape)} vs {tuple(f1_ext.shape)}")
    n = f0_ext.shape[0]
    lo, hi = max(0, -r0), min(n, h - r0)
    out = torch.zeros((n, w, 2), dtype=torch.float32, device=f0_ext.device)
    if hi > lo:
        out[lo:hi] = kmotion.me_fast_kernel(
            f0_ext[lo:hi][None].contiguous(), f1_ext[lo:hi][None].contiguous(),
            search_size, patch_size, costfn,
        )[0]
    return out


def exact_flow_bound(levels: int, search_size: int = 15, patch_size: int = 5) -> int:
    """Analytic bound on |flow| per axis for the exact pyramid in 'fixed'
    seed mode, px.

    One level's search moves at most sum(steps) px from its seed (8 at 15/5:
    steps 5, 2, 1), and coarse-to-fine seeding doubles the previous level's
    flow (bilinear resize is a convex combination; the median selects one of
    its inputs), so |f_L| <= 2 |f_{L-1}| + sum(steps) and the finest level
    is bounded by (2**levels - 1) * sum(steps): 56 at the defaults. The JAX
    package's function of this name counts search_size // 2 = 7 px per
    level (49), one short of what the step schedule reaches.
    """
    return (2**levels - 1) * sum(me_steps(search_size, patch_size))


def _warn_seed_saturation(base_max: float, bound: int, what: str) -> None:
    if base_max > bound:
        warnings.warn(
            f"seed displacements reach {base_max:.0f} px but {what}={bound} "
            f"clamps the seed base to [-{bound}, {bound}]; the flow "
            "saturates there. Raise the bound (or disable the clamp) for "
            "larger motion.",
            RuntimeWarning,
            stacklevel=4,
        )


def _base_max(seed: torch.Tensor) -> float:
    """max |trunc(seed)|, read back to the host (one synchronisation)."""
    return float(torch.trunc(seed).abs().max())


def _quantum(base_max: float) -> int:
    """The smallest of SEED_BOUND_QUANTA that holds ``base_max`` (else the
    largest)."""
    for q in SEED_BOUND_QUANTA:
        if base_max <= q:
            return q
    return SEED_BOUND_QUANTA[-1]


def _fast(g0, g1, seed, search_size, patch_size, seed_mode, wb, costfn, stages: Stages):
    """Fast mode around a seed: ``wb`` None gathers the full field every
    round; otherwise frame 1 is gather-warped once by the seed base
    (clamped to [-wb, wb] when ``wb`` >= 0) and the rounds run on the
    residual, which the base and, in 'shipped' mode, the seed are added
    to."""
    if seed is None:
        return stages.fast(g0, g1, search_size, patch_size, costfn)
    base_y, base_x = kmotion._seed_base(seed, wb if wb is not None and wb >= 0 else None)
    if wb is None:
        flow = stages.fast(
            g0, g1, search_size, patch_size, costfn,
            init=(base_y.to(torch.int32).contiguous(), base_x.to(torch.int32).contiguous()),
        )
    else:
        ys, xs = kmotion._grid(g0.shape[1], g0.shape[2], g0.device)
        base1 = kmotion.gather_padded(g1, ys + base_y, xs + base_x).contiguous()
        res = stages.fast(g0, base1, search_size, patch_size, costfn)
        flow = torch.stack([base_x, base_y], dim=-1).to(torch.float32) + res
    return seed + flow if seed_mode == "shipped" else flow


def _estimate(
    g0, g1, seed, search_size, patch_size, seed_mode, method, costfn, warp_bound, seed_bound,
    stages: Stages = KERNEL_STAGES,
) -> torch.Tensor:
    """[B, H, W] uint8 frames and an optional [B, H, W, 2] float32 seed ->
    [B, H, W, 2] float32 through ``stages``."""
    if seed_mode not in ("shipped", "fixed"):
        raise ValueError(seed_mode)
    if costfn not in kmotion.INT_COSTS + kmotion.FLOAT_COSTS:
        raise ValueError(f"unknown costfn {costfn!r}")
    if method == "fast":
        if costfn not in kmotion.INT_COSTS:
            raise ValueError(f"costfn {costfn!r} requires method='exact'")
        if warp_bound == "auto":
            wb = -1
        elif warp_bound == "gather":
            wb = None
        else:
            wb = int(warp_bound)
            if wb < 0:
                raise ValueError("warp_bound must be 'auto', 'gather', or an int >= 0")
            if seed is not None:
                _warn_seed_saturation(_base_max(seed), wb, "warp_bound")
        return _fast(g0, g1, seed, search_size, patch_size, seed_mode, wb, costfn, stages)
    if method != "exact":
        raise ValueError(f"unknown method {method!r}")
    if costfn in kmotion.FLOAT_COSTS:
        # float costs never ran in a kernel: the windowed gather, no clamp
        return kmotion.me_exact(g0, g1, search_size, patch_size, costfn, seed, None, seed_mode)
    sb = None
    if seed is not None and seed_bound not in (None, "none"):
        base_max = _base_max(seed)
        sb = _quantum(base_max) if seed_bound == "auto" else int(seed_bound)
        _warn_seed_saturation(base_max, sb, "seed_bound")
    return stages.exact(g0, g1, search_size, patch_size, costfn, seed, sb, seed_mode)


def estimate_motion_vector(
    gray0,
    gray1,
    search_size: int = 15,
    patch_size: int = 5,
    seed=None,
    seed_mode: str = "shipped",
    method: str = "exact",
    costfn: str = "sad",
    warp_bound="auto",
    seed_bound="auto",
    *,
    device=None,
) -> torch.Tensor:
    """Dense integer block-matching flow [H, W, 2] (u=x, v=y) float32.

    Defaults match me_pyramid.py:130. Accepts [H, W] or batched [B, H, W]
    uint8 frames (seed batched alike). ``method='exact'`` is bit-identical
    to the reference search; ``method='fast'`` uses the warp-based
    approximation. ``costfn`` in {'sad', 'ssd', 'wsad_shipped', 'wsad'}
    selects the match cost (me_pyramid.py:29-48); the WSAD variants are
    exact-mode only and run as torch ops, never in a kernel.

    ``warp_bound`` (fast mode only): 'auto' gather-warps frame 1 once by the
    seed base, with NO clamp, and iterates on the bounded search residual
    (on every device; the JAX package does so on the TPU only). 'gather'
    gathers the full field every round, which gives another flow; an int
    B >= 0 is 'auto' with the seed base clamped to [-B, B] once on entry,
    and warns when the seed actually saturates.

    ``seed_bound`` (exact mode with a seed, SAD/SSD): the seed base is
    clamped to [-B, B]; bit-identical to the oracle whenever
    |trunc(seed)| <= B, with a warning when the seed saturates. 'auto'
    sizes B from the seed itself (its largest |trunc|, rounded up to
    {8, 12, 16, 20, 24, 32}; one host synchronisation); an int sets B;
    'none' means no clamp.
    """
    g0, g1, single = _frames(gray0, gray1, device, "estimate_motion_vector")
    sd = None
    if seed is not None:
        sd = _flow(seed, None, g0)
        sd = (sd[None] if single else sd).contiguous()
    out = _estimate(
        g0, g1, sd, search_size, patch_size, seed_mode, method, costfn, warp_bound, seed_bound
    )
    return out[0] if single else out


def _halfpixel_taps(n_out: int, n_in: int):
    """cv2.INTER_LINEAR tap indices/weights."""
    x = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    x0 = np.floor(x)
    u = x - x0
    i0 = x0.astype(np.int64)
    u = np.where(i0 < 0, 0.0, u)
    u = np.where(i0 >= n_in - 1, 1.0, u)
    i0 = np.clip(i0, 0, n_in - 1)
    i1 = np.clip(i0 + 1, 0, n_in - 1)
    return i0, i1, u.astype(np.float32)


def _resize_halfpixel(a: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """cv2.INTER_LINEAR-style resize (half-pixel centres) of float32
    [..., H, W]: rows first, then columns."""
    dev = a.device
    y0, y1, vy = _halfpixel_taps(out_hw[0], a.shape[-2])
    x0, x1, ux = _halfpixel_taps(out_hw[1], a.shape[-1])

    def t(arr):
        return torch.from_numpy(arr).to(dev)

    rows = a[..., t(y0), :] * t(1 - vy)[:, None] + a[..., t(y1), :] * t(vy)[:, None]
    return rows[..., t(x0)] * t(1 - ux) + rows[..., t(x1)] * t(ux)


def resize_bilinear_halfpixel(img, out_hw: Tuple[int, int], *, device=None) -> torch.Tensor:
    """cv2.INTER_LINEAR-style float resize (half-pixel centers) of [H, W]."""
    return _resize_halfpixel(as_tensor(img, device).to(torch.float32), tuple(out_hw))


def upscale_mv(mv, scale: int, mode: str = "shipped", *, device=None) -> torch.Tensor:
    """Coarse-to-fine flow seeding (me_test.py:51-63 semantics).

    'shipped' reproduces the reference's max-normalized resize (wrong for
    all-negative components, div-by-zero if max==0); 'fixed' resizes and
    scales directly. Accepts [H, W, 2] or batched [B, H, W, 2] (per-frame
    max-normalization).
    """
    t = _flow(mv, device)
    planes = t.movedim(-1, -3)  # [..., 2, H, W]
    h, w = planes.shape[-2:]
    out_hw = (h * scale, w * scale)
    if mode == "shipped":
        pmax = planes.amax(dim=(-2, -1), keepdim=True)
        out = _resize_halfpixel(planes / pmax, out_hw) * (pmax * scale)
    elif mode == "fixed":
        out = _resize_halfpixel(planes, out_hw) * scale
    else:
        raise ValueError(mode)
    return out.movedim(-3, -1).contiguous()


def median_filter_flow(mv, k: int = 5, *, device=None) -> torch.Tensor:
    """k x k per-component median filter of a [H, W, 2] (or batched
    [B, H, W, 2]) flow field, edges replicated.

    The median of an odd number of finite values is unique, so selecting it
    from the unfolded window equals the JAX package's comparator network.
    Inputs are assumed finite.
    """
    t = _flow(mv, device)
    if k < 1 or k % 2 == 0:
        raise ValueError(f"median kernel size must be odd, got {k}")
    h, w = t.shape[-3:-1]
    planes = t.movedim(-1, -3).reshape(-1, 1, h, w)  # [N, 1, H, W]
    out = torch.empty_like(planes)
    # two planes at a time: the unfolded window holds k*k copies
    for i in range(0, planes.shape[0], 2):
        pd = F.pad(planes[i : i + 2], (k // 2,) * 4, mode="replicate")
        win = F.unfold(pd, k)  # [n, k*k, H*W]
        out[i : i + 2] = win.median(dim=1).values.reshape(-1, 1, h, w)
    return out.reshape(*t.shape[:-3], 2, h, w).movedim(-3, -1).contiguous()


def _refine_subpixel(g0, g1, flow, patch_size: int, costfn: str) -> torch.Tensor:
    """[B, H, W] uint8 frames, [B, H, W, 2] flow -> round(flow) + offset."""
    h, w = g0.shape[1:]
    ys, xs = kmotion._grid(h, w, g0.device)
    iu = torch.round(flow[..., 0]).to(torch.int64)
    iv = torch.round(flow[..., 1]).to(torch.int64)
    f0 = g0.to(torch.int32)

    def cost(dy, dx):
        d = f0 - kmotion.gather_padded(g1, ys + iv + dy, xs + iu + dx).to(torch.int32)
        return kmotion._boxsum(d.abs() if costfn == "sad" else d * d, patch_size).to(torch.float32)

    c0 = cost(0, 0)
    cxm, cxp = cost(0, -1), cost(0, 1)
    cym, cyp = cost(-1, 0), cost(1, 0)

    def delta(cm, cc, cp):
        if costfn == "sad":
            # SAD of a translated signal is V-shaped: the equiangular fit
            d = (cm - cp) / torch.clamp(2.0 * (torch.maximum(cm, cp) - cc), min=1e-12)
        else:  # ssd: quadratic near the minimum - parabola fit
            denom = cm + cp - 2.0 * cc
            d = torch.where(denom > 0, (cm - cp) / torch.clamp(2.0 * denom, min=1e-12), 0.0)
        # only trust an interior minimum of the 1-D cost section
        d = torch.where((cm >= cc) & (cp >= cc), d, 0.0)
        return torch.clamp(d, -0.5, 0.5)

    du = delta(cxm, c0, cxp)
    dv = delta(cym, c0, cyp)
    return torch.stack([iu.to(torch.float32) + du, iv.to(torch.float32) + dv], dim=-1)


def refine_flow_subpixel(
    gray0, gray1, flow, patch_size: int = 5, costfn: str = "sad", *, device=None
) -> torch.Tensor:
    """Subpixel flow refinement: a 1-D fit per axis on the local cost surface.

    For each pixel, the patch cost is evaluated at the ROUNDED (half to
    even) integer flow and its 4 axis neighbors (same zero-padded patch
    convention as the search, each patch compared at its own pixel's
    displacement), and the equiangular (SAD) or parabola (SSD) fit places
    the minimum within [-0.5, 0.5] of the integer winner. Pixels whose
    integer flow is not an interior minimum keep their integer value.
    Accepts [H, W] or [B, H, W] frames with flow [..., H, W, 2].
    """
    if costfn not in kmotion.INT_COSTS:
        raise ValueError(f"subpixel refinement needs sad/ssd, got {costfn!r}")
    g0, g1, single = _frames(gray0, gray1, device, "refine_flow_subpixel")
    fl = _flow(flow, None, g0)
    out = _refine_subpixel(g0, g1, fl[None] if single else fl, patch_size, costfn)
    return out[0] if single else out


def estimate_motion_pyramid(
    gray0,
    gray1,
    levels: int = 3,
    search_size: int = 15,
    patch_size: int = 5,
    seed_mode: str = "fixed",
    method: str = "exact",
    smooth: int = 0,
    warp_bound="auto",
    seed_bound="auto",
    subpixel: int = 0,
    refine: str = "auto",
    *,
    device=None,
) -> List[torch.Tensor]:
    """Coarse-to-fine estimation (me_test.py:76-90): returns per-level flows,
    index 0 = coarsest, last = full resolution. Accepts [H, W] frames or
    batched [B, H, W] stacks (per-level flows come back [B, h, w, 2]).

    ``smooth`` > 0 median-filters each level's flow (kernel size ``smooth``)
    before seeding the next level and on the final output. ``subpixel`` > 0
    replaces that single median with ``subpixel`` rounds of (subpixel
    refinement -> median smooth, kernel ``smooth`` or 5) per level.

    ``warp_bound`` and ``seed_bound`` pass through to
    ``estimate_motion_vector``.

    ``refine``: 'auto' (active for method='fast' and more than one level)
    runs the HYBRID schedule: the coarsest level by the unseeded exact
    search, every later level by the fast iteration followed by ONE
    seeded-exact pass around its median-smoothed flow, whose bound is sized
    from that flow ({8..32}) and which the flow is clipped to. 'exact'
    forces the same refinement passes for any method; 'none' disables them.
    """
    with tracing.span("ocv.motion"):
        g0, g1, single = _frames(gray0, gray1, device, "estimate_motion_pyramid")
        flows = _pyramid(
            g0, g1, levels, search_size, patch_size, seed_mode, method, smooth, warp_bound,
            seed_bound, subpixel, refine,
        )
        return [f[0] for f in flows] if single else flows


def _pyramid(
    g0, g1, levels, search_size, patch_size, seed_mode, method, smooth, warp_bound, seed_bound,
    subpixel, refine, stages: Stages = KERNEL_STAGES,
) -> List[torch.Tensor]:
    """[B, H, W] uint8 frames -> per-level [B, h, w, 2] flows through
    ``stages``."""
    if refine not in ("auto", "exact", "none"):
        raise ValueError(f"unknown refine mode {refine!r}")
    with tracing.span("ocv.pyramid"):
        pyr0 = gaussian_pyramid(g0, 2, levels, batched=True)
        pyr1 = gaussian_pyramid(g1, 2, levels, batched=True)
    # 'auto' needs >= 2 levels: with one level the "coarsest" IS the full
    # frame, and an exact search there is not what a fast call asked for
    do_refine = refine == "exact" or (refine == "auto" and method == "fast" and levels > 1)
    sk = smooth if smooth > 0 else 5
    flows = []
    seed = None
    for lv in range(levels):
        p0, p1 = pyr0[lv].contiguous(), pyr1[lv].contiguous()
        lv_method = "exact" if do_refine and method == "fast" and lv == 0 else method
        with tracing.span(f"ocv.motion.{lv_method}"):
            mv = _estimate(
                p0, p1, seed, search_size, patch_size, seed_mode, lv_method, "sad", warp_bound,
                seed_bound, stages,
            )
        if do_refine and lv > 0:
            # the seed is our own intermediate: size the bound from it,
            # clip the outlier tail to it and pass the same bound down, so
            # the pass never saturates and never warns
            with tracing.span("ocv.motion.median"):
                rs = median_filter_flow(mv, sk)
            with tracing.span("ocv.motion.exact"):
                rb = _quantum(_base_max(rs))
                rs = torch.clamp(rs, -float(rb), float(rb))
                mv = _estimate(
                    p0, p1, rs, search_size, patch_size, "fixed", "exact", "sad", warp_bound, rb,
                    stages,
                )
        if subpixel > 0:
            for _ in range(subpixel):
                with tracing.span("ocv.motion.subpixel"):
                    mv = _refine_subpixel(p0, p1, mv, patch_size, "sad")
                with tracing.span("ocv.motion.median"):
                    mv = median_filter_flow(mv, sk)
        elif smooth > 0:
            with tracing.span("ocv.motion.median"):
                mv = median_filter_flow(mv, smooth)
        flows.append(mv)
        if lv + 1 < levels:
            with tracing.span("ocv.motion.upscale"):
                seed = upscale_mv(mv, 2, mode=seed_mode)
    return flows
