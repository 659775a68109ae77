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
  (``median_filter_flow``: the hand-written ``kernels.motion.flow_median_kernel``
  for a CUDA tensor, the plain ``F.unfold`` and ``Tensor.median`` of
  ``kernels.motion.flow_median`` for a CPU one), seed upscaling
  (``upscale_mv``), subpixel rounds (``refine_flow_subpixel``: the
  hand-written ``kernels.motion.subpixel_fit_kernel`` for a CUDA tensor, the
  plain torch ops of ``kernels.motion.subpixel_fit`` for a CPU one) and the
  hybrid fast + seeded-exact schedule.

Under a profiler a pyramid call is the span ``ocv.motion`` of
``utils.tracing``, with its stages inside: ``ocv.pyramid`` (both Gaussian
pyramids), ``ocv.motion.exact`` (an exact search; a refinement's bound
sizing and clip with it), ``ocv.motion.fast`` (the fast iteration with its
seed-base gather), ``ocv.motion.median`` (each ``median_filter_flow``: on
the card one ``flow_median`` launch),
``ocv.motion.subpixel`` (each subpixel fit: on the card one
``subpixel_fit`` launch) and ``ocv.motion.upscale``
(each ``upscale_mv``).

On the card a pyramid call whose arguments make it free of host syncs
(``replays``) is captured once as a CUDA graph and then replayed: a key's
(device, frame shape, arguments) first call runs eagerly, its second
captures the graph, and that call and every later one replay it, in the
span ``ocv.motion.replay`` (the stages' spans do not run: a replay runs no
Python). ``GRAPH_CALLS`` counts the calls by path; ``kernels._build.LAUNCHES``
counts the launches of eager calls and captures, never a replay's.

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

import collections
import functools
import warnings
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from oclcomputervision_tpu_torch._device import as_tensor
from oclcomputervision_tpu_torch.kernels import motion as kmotion
from oclcomputervision_tpu_torch.ops._layout import guard_batch_first
from oclcomputervision_tpu_torch.ops.pyramid import gaussian_pyramid
from oclcomputervision_tpu_torch.oracle.motion import me_steps
from oclcomputervision_tpu_torch.utils import tracing

SEED_BOUND_QUANTA = (8, 12, 16, 20, 24, 32)
GRAPH_KEYS = 8  # keys whose graph (or first call) is kept; the least recently used goes first
# pyramid calls by path: eager (a CPU tensor, arguments that sync, a key's
# first call), capture (a key's second: captured, then replayed), replay
GRAPH_CALLS = {"eager": 0, "capture": 0, "replay": 0}


class Stages(NamedTuple):
    """The four kernel stages the motion ops run."""

    exact: Callable
    fast: Callable
    median: Callable
    subpixel: Callable


# the kernel wrappers (plain versions for CPU tensors, kernels for CUDA ones)
KERNEL_STAGES = Stages(kmotion.me_exact_kernel, kmotion.me_fast_kernel,
                       kmotion.flow_median_kernel, kmotion.subpixel_fit_kernel)
# the plain PyTorch versions on any device (the kernels' reference on the card)
PLAIN_STAGES = Stages(kmotion.me_exact, kmotion.me_fast, kmotion.flow_median,
                      kmotion.subpixel_fit)


def _frame_views(gray0, gray1, device, op: str):
    """Two uint8 frames [H, W] or batch-first [B, H, W] -> ([B, H, W] views
    of each, whether the input was one pair)."""
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
    return g0, g1, single


def _frames(gray0, gray1, device, op: str):
    """``_frame_views``, each frame contiguous."""
    g0, g1, single = _frame_views(gray0, gray1, device, op)
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


@functools.lru_cache(maxsize=64)
def _halfpixel_table(n_out: int, n_in: int, device: torch.device):
    """``_halfpixel_taps`` on ``device``, copied there once: (i0, i1, 1 - u,
    u), each [n_out]. A copy from host memory synchronises the card, and a
    CUDA graph cannot hold one."""
    i0, i1, u = _halfpixel_taps(n_out, n_in)
    return tuple(torch.from_numpy(t).to(device) for t in (i0, i1, 1 - u, u))


def _resize_halfpixel(a: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """cv2.INTER_LINEAR-style resize (half-pixel centres) of float32
    [..., H, W]: rows first, then columns."""
    y0, y1, wy0, wy1 = _halfpixel_table(out_hw[0], a.shape[-2], a.device)
    x0, x1, wx0, wx1 = _halfpixel_table(out_hw[1], a.shape[-1], a.device)
    rows = a[..., y0, :] * wy0[:, None] + a[..., y1, :] * wy1[:, None]
    return rows[..., x0] * wx0 + rows[..., x1] * wx1


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
    [B, H, W, 2]) flow field, edges replicated, k odd.

    A CUDA tensor runs the hand-written kernel (``csrc/flow_median.cu``,
    one launch for both planes and the batch), a CPU tensor the plain
    version (``F.unfold`` and ``Tensor.median``). The median of an odd
    number of finite values is unique, so both equal the JAX package's
    comparator network (where the median is a zero, the kernel may give it
    the other sign). Inputs are assumed finite.
    """
    t = _flow(mv, device)
    out = kmotion.flow_median_kernel(t.reshape(-1, *t.shape[-3:]).contiguous(), k)
    return out.reshape(t.shape)


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

    A CUDA tensor runs the hand-written kernel (``csrc/subpixel_fit.cu``,
    one launch for the batch; odd patches up to 31), a CPU tensor the plain
    version (``kernels.motion.subpixel_fit``); both give the same flow bit
    for bit. Flows are assumed finite.
    """
    if costfn not in kmotion.INT_COSTS:
        raise ValueError(f"subpixel refinement needs sad/ssd, got {costfn!r}")
    g0, g1, single = _frames(gray0, gray1, device, "refine_flow_subpixel")
    fl = _flow(flow, None, g0)
    fl = (fl[None] if single else fl).contiguous()
    out = kmotion.subpixel_fit_kernel(g0, g1, fl, patch_size, costfn)
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
    seeded-exact pass around its median-smoothed flow, whose seed base is
    clamped to [-32, 32] (the largest of SEED_BOUND_QUANTA). 'exact' forces
    the same refinement passes for any method; 'none' disables them.

    On the card, where ``replays`` admits the arguments, a key's second
    call captures a CUDA graph and later calls replay it (module
    docstring); the flows are the eager call's, in fresh tensors.
    """
    with tracing.span("ocv.motion"):
        g0, g1, single = _frame_views(gray0, gray1, device, "estimate_motion_pyramid")
        args = (levels, search_size, patch_size, seed_mode, method, smooth, warp_bound,
                seed_bound, subpixel, refine)
        if replays(g0.device, levels, method, warp_bound, seed_bound):
            with torch.cuda.device(g0.device):
                flows = _replayed(g0, g1, args)
        else:
            flows = _eager(g0, g1, args)
        return [f[0] for f in flows] if single else flows


def replays(device, levels: int, method: str, warp_bound, seed_bound) -> bool:
    """Whether a pyramid call on ``device`` with these arguments may replay
    as a CUDA graph: a CUDA device, at least one level, and no stage that
    reads back to the host once the seed upscale's tap tables are cached.
    Only a seeded level (any after the first) may read back: the fast
    search under an int ``warp_bound`` and the exact search under
    ``seed_bound`` 'auto' or an int read the seed's largest displacement
    back (for the saturation warning, and 'auto' to size the bound). The
    hybrid refinement's bound is fixed and reads nothing back."""
    if torch.device(device).type != "cuda" or levels < 1:
        return False
    if levels == 1:
        return True
    if method == "fast":
        return warp_bound in ("auto", "gather")
    return seed_bound in (None, "none")


def _eager(g0, g1, args) -> List[torch.Tensor]:
    GRAPH_CALLS["eager"] += 1
    return _pyramid(g0.contiguous(), g1.contiguous(), *args)


class _Replay(NamedTuple):
    """A captured pyramid call."""

    graph: "torch.cuda.CUDAGraph"
    frames: Tuple[torch.Tensor, torch.Tensor]  # the static [B, H, W] inputs
    flows: List[torch.Tensor]  # the static outputs, overwritten by each replay
    done: "torch.cuda.Event"  # recorded once a replay's flows are copied out
    # the tap tables the graph reads, held while it lives: the cache may drop them
    taps: list


# (device, frame shape, arguments) -> None once its first call has run
# eagerly, then its captured call; the most recently used last
_GRAPHS: "collections.OrderedDict[tuple, Optional[_Replay]]" = collections.OrderedDict()


def _replayed(g0, g1, args) -> List[torch.Tensor]:
    """A call that ``replays`` admits: eager at its key's first call (which
    loads the kernel library and fills the tap cache, neither of which a
    capture may do), captured at its second, replayed from then on."""
    key = (g0.device, tuple(g0.shape), *args)
    if key not in _GRAPHS:
        flows = _eager(g0, g1, args)
        _GRAPHS[key] = None
        while len(_GRAPHS) > GRAPH_KEYS:
            _GRAPHS.popitem(last=False)
        return flows
    _GRAPHS.move_to_end(key)
    rep = _GRAPHS[key]
    if rep is None:
        rep = _GRAPHS[key] = _capture(g0, args)
        GRAPH_CALLS["capture"] += 1
    else:
        GRAPH_CALLS["replay"] += 1
    with tracing.span("ocv.motion.replay"):
        # the last replay's flows are copied out before its buffers are
        # reused, on whichever stream each call runs
        torch.cuda.current_stream().wait_event(rep.done)
        rep.frames[0].copy_(g0)
        rep.frames[1].copy_(g1)
        rep.graph.replay()
        flows = [f.clone() for f in rep.flows]
        rep.done.record()
        return flows


def _capture(g0, args) -> _Replay:
    """Capture the pyramid call of frames shaped as ``g0`` (on a side
    stream: nothing runs) around static frames of that shape."""
    frames = (torch.empty(g0.shape, dtype=torch.uint8, device=g0.device),
              torch.empty(g0.shape, dtype=torch.uint8, device=g0.device))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        flows = _pyramid(*frames, *args)
    # each upscale_mv of a level's [B, h, w, 2] flow reads the tables of
    # (2h, h) and (2w, w), which the capture has just used
    taps = [_halfpixel_table(2 * n, n, g0.device) for f in flows[:-1] for n in f.shape[1:3]]
    return _Replay(graph, frames, flows, torch.cuda.Event(), taps)


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
            # the seed is our own intermediate, and the search reads it as
            # clamp(trunc(seed), -B, B) alone: the largest quantum gives the
            # flow of every smaller one that holds the seed, with no
            # read-back to size B, and the pass never warns
            with tracing.span("ocv.motion.median"):
                rs = stages.median(mv, sk)
            with tracing.span("ocv.motion.exact"):
                mv = stages.exact(p0, p1, search_size, patch_size, "sad", rs,
                                  SEED_BOUND_QUANTA[-1], "fixed")
        if subpixel > 0:
            for _ in range(subpixel):
                with tracing.span("ocv.motion.subpixel"):
                    mv = stages.subpixel(p0, p1, mv, patch_size, "sad")
                with tracing.span("ocv.motion.median"):
                    mv = stages.median(mv, sk)
        elif smooth > 0:
            with tracing.span("ocv.motion.median"):
                mv = stages.median(mv, smooth)
        flows.append(mv)
        if lv + 1 < levels:
            with tracing.span("ocv.motion.upscale"):
                seed = upscale_mv(mv, 2, mode=seed_mode)
    return flows
