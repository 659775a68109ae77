"""Block-matching motion estimation kernels: the exact shrinking-step search
and the fast (warp-based) iteration.

Ports of ``oclcomputervision_tpu/ops/pallas/me_pallas.py`` and
``me_fast_pallas.py``:

- ``me_exact`` (plain) / ``me_exact_kernel`` (wrapper over
  ``csrc/me_exact.cu``) replace both ``me_exact_pallas`` (unseeded) and
  ``_seeded_impl`` (seeded, the seed's base clamped to [-B, B]): [B, H, W]
  uint8 frames and an optional [B, H, W, 2] float32 seed -> [B, H, W, 2]
  float32 integer-valued flow (u = x, v = y). The plain version is a
  transliteration of the XLA windowed gather ``ops/motion._estimate_2d``,
  one image at a time, and also carries the float WSAD costs, which never
  ran in a Pallas kernel.
- ``me_fast`` (plain) / ``me_fast_kernel`` (``csrc/me_fast_round.cu`` and
  ``csrc/me_fast_median.cu``, one launch of each per round) replace
  ``me_fast_residual_pallas``: frame 0 and the (seed-base-warped) frame 1 ->
  the residual flow of ``ops/motion._fast_rounds``. An initial state turns
  the same rounds into the per-round gather of the full field.

All arithmetic is integer, so each kernel equals its plain version, the JAX
package's XLA twins and the numpy oracle bit for bit. Each wrapper takes the
plain version for a CPU tensor and launches its kernels for a CUDA tensor.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from oclcomputervision_tpu_torch.kernels._build import launch, require_cuda_tensor
from oclcomputervision_tpu_torch.kernels.histeq import MAX_GRID_YZ
from oclcomputervision_tpu_torch.oracle.motion import MEDIAN9_EXCHANGES, gaussian2d, me_steps

MAX_STEPS = 16  # csrc/me_exact.cu's kMaxSteps
ME_BLOCK = (8, 32)  # csrc/me_exact.cu's kBlockY, kBlockX: pixels per block
ME_ROW_PAD = 8  # csrc/me_exact.cu's kRowPad
ME_WINDOW_CAP = 32 * 1024  # shared-memory bytes a block's frame-1 window may take
FAST_MAX_PATCH = 31  # csrc/me_fast_round.cu: a warp's 32 columns hold the patch's reach
INT_COSTS = ("sad", "ssd")  # the costs the kernels take
FLOAT_COSTS = ("wsad_shipped", "wsad")  # exact search only, plain version only


def gather_padded(img: torch.Tensor, yy: torch.Tensor, xx: torch.Tensor) -> torch.Tensor:
    """img[b, yy, xx] with zeros outside the image (me_pyramid.py:89-127):
    img [B, H, W], integer yy and xx [B or 1, ...] that broadcast together."""
    b, h, w = img.shape
    valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
    flat = yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
    lead = torch.arange(b, device=img.device).reshape((b,) + (1,) * (flat.ndim - 1))
    vals = img.reshape(-1)[flat + lead * (h * w)]
    return torch.where(valid, vals, torch.zeros((), dtype=img.dtype, device=img.device))


def _grid(h: int, w: int, device):
    ys = torch.arange(h, device=device)[:, None].expand(h, w)
    xs = torch.arange(w, device=device)[None, :].expand(h, w)
    return ys, xs


def _first_min(costs) -> torch.Tensor:
    """Index of the first minimum over a list of same-shape cost maps (a
    strict < over candidates in order, as the kernels take it)."""
    best_c = costs[0]
    best_i = torch.zeros(costs[0].shape, dtype=torch.int64, device=costs[0].device)
    for k in range(1, len(costs)):
        better = costs[k] < best_c
        best_c = torch.where(better, costs[k], best_c)
        best_i = torch.where(better, k, best_i)
    return best_i


def _seed_base(seed: torch.Tensor, bound: Optional[int]):
    """(base_y, base_x) int64 [B, H, W]: trunc(seed) toward zero (v for rows,
    u for columns), clamped to [-bound, bound] unless ``bound`` is None."""
    base_y = torch.trunc(seed[..., 1]).to(torch.int64)
    base_x = torch.trunc(seed[..., 0]).to(torch.int64)
    if bound is not None:
        base_y = base_y.clamp(-bound, bound)
        base_x = base_x.clamp(-bound, bound)
    return base_y, base_x


def _cost(patches: torch.Tensor, cand: torch.Tensor, costfn: str, patch_size: int):
    """Candidate cost over the trailing [ps, ps] axes (me_pyramid.py:29-48):
    SAD and SSD in int32, the WSAD variants in float32 with the reference's
    sigma = 2 Gaussian ('wsad_shipped' keeps its matrix-product quirk)."""
    if costfn == "sad":
        return (patches - cand).abs().sum(dim=(-2, -1))
    if costfn == "ssd":
        d = patches - cand
        return (d * d).sum(dim=(-2, -1))
    w = torch.from_numpy(gaussian2d((patch_size, patch_size), 2.0)).to(
        device=patches.device, dtype=torch.float32
    )
    p0, p1 = patches.to(torch.float32), cand.to(torch.float32)
    if costfn == "wsad_shipped":
        return (p0 @ w - p1 @ w).abs().sum(dim=(-2, -1))
    if costfn == "wsad":
        return ((p0 - p1).abs() * w).sum(dim=(-2, -1))
    raise ValueError(f"unknown costfn {costfn!r}")


def _check_frames(f0: torch.Tensor, f1: torch.Tensor, seed: Optional[torch.Tensor]) -> None:
    if f0.dtype != torch.uint8 or f0.ndim != 3 or f1.dtype != torch.uint8:
        raise ValueError(f"frames must be uint8 [B, H, W], got {f0.dtype} {tuple(f0.shape)}")
    if f1.shape != f0.shape or f1.device != f0.device:
        raise ValueError(f"frames differ: {tuple(f0.shape)} vs {tuple(f1.shape)}")
    if seed is not None and (
        seed.dtype != torch.float32 or tuple(seed.shape) != (*f0.shape, 2) or seed.device != f0.device
    ):
        raise ValueError(
            f"seed must be float32 {(*f0.shape, 2)} on {f0.device}, got {seed.dtype} "
            f"{tuple(seed.shape)}"
        )


def _check_grid(b: int, h: int, w: int) -> None:
    if b > MAX_GRID_YZ or h > 8 * MAX_GRID_YZ or h * w >= 2**31:
        raise ValueError(f"grid too large: images={b}, {h}x{w}")


def me_exact(
    f0: torch.Tensor,
    f1: torch.Tensor,
    search_size: int = 15,
    patch_size: int = 5,
    costfn: str = "sad",
    seed: Optional[torch.Tensor] = None,
    seed_bound: Optional[int] = None,
    seed_mode: str = "shipped",
) -> torch.Tensor:
    """Plain version of the exact search: a per-pixel window gather around
    the current centre each round, one image at a time (the window of a
    VGA image at 15/5 is [480, 640, 15, 15])."""
    _check_frames(f0, f1, seed)
    if seed_mode not in ("shipped", "fixed"):
        raise ValueError(seed_mode)
    b, h, w = f0.shape
    pm = patch_size // 2
    ys, xs = _grid(h, w, f0.device)
    offs = torch.arange(patch_size, device=f0.device) - pm
    out = []
    for n in range(b):
        g0, g1 = f0[n : n + 1], f1[n : n + 1]
        cy, cx = ys, xs
        if seed is not None:
            base_y, base_x = _seed_base(seed[n], seed_bound)
            cy, cx = ys + base_y, xs + base_x
        patches = gather_padded(
            g0, (ys[:, :, None, None] + offs[:, None])[None],
            (xs[:, :, None, None] + offs[None, :])[None],
        )[0].to(torch.int32)
        for step in me_steps(search_size, patch_size):
            woffs = torch.arange(patch_size + 2 * step, device=f0.device) - (pm + step)
            window = gather_padded(
                g1, (cy[:, :, None, None] + woffs[:, None])[None],
                (cx[:, :, None, None] + woffs[None, :])[None],
            )[0].to(torch.int32)
            costs = [
                _cost(
                    patches,
                    window[:, :, iy * step : iy * step + patch_size,
                           ix * step : ix * step + patch_size],
                    costfn, patch_size,
                )
                for iy in range(3)
                for ix in range(3)
            ]
            best = _first_min(costs)
            cy = cy + (best // 3 - 1) * step
            cx = cx + (best % 3 - 1) * step
        flow = torch.stack([(cx - xs).to(torch.float32), (cy - ys).to(torch.float32)], dim=-1)
        if seed is not None and seed_mode == "shipped":
            flow = seed[n] + flow
        out.append(flow)
    return torch.stack(out)


def me_window_bytes(steps, patch_size: int, seeded: bool, bound: Optional[int]) -> int:
    """Shared-memory bytes ``csrc/me_exact.cu`` reserves per block for its
    frame-1 window: the block's tile grown on each side by
    ``patch_size // 2 + sum(steps)`` and, for a seed clamped to [-bound,
    bound], by the bound, in rows padded as the kernel pads them; at most
    ``ME_WINDOW_CAP``, which is also what a seed without a bound gets. A
    block whose own window (its seeds' spread) does not fit reads frame 1
    from device memory instead."""
    reach = patch_size // 2 + sum(steps)
    if seeded:
        if bound is None:
            return ME_WINDOW_CAP
        reach += bound
    rows, cols = ME_BLOCK[0] + 2 * reach, ME_BLOCK[1] + 2 * reach
    return min(rows * (-(-cols // 4) * 4 + ME_ROW_PAD), ME_WINDOW_CAP)


def me_exact_kernel(
    f0: torch.Tensor,
    f1: torch.Tensor,
    search_size: int = 15,
    patch_size: int = 5,
    costfn: str = "sad",
    seed: Optional[torch.Tensor] = None,
    seed_bound: Optional[int] = None,
    seed_mode: str = "shipped",
) -> torch.Tensor:
    """Wrapper: the plain version for CPU tensors, the CUDA kernel for CUDA
    tensors (contiguous [B, H, W] uint8, seed [B, H, W, 2] float32; SAD or
    SSD, an odd patch size, at most 16 rounds)."""
    if f0.device.type == "cpu":
        return me_exact(f0, f1, search_size, patch_size, costfn, seed, seed_bound, seed_mode)
    require_cuda_tensor(f0, "f0", torch.uint8, 3)
    require_cuda_tensor(f1, "f1", torch.uint8, 3)
    if seed is not None:
        require_cuda_tensor(seed, "seed", torch.float32, 4)
    _check_frames(f0, f1, seed)
    if costfn not in INT_COSTS:
        raise ValueError(f"the kernel takes {INT_COSTS}, got costfn {costfn!r}")
    if seed_mode not in ("shipped", "fixed"):
        raise ValueError(seed_mode)
    steps = me_steps(search_size, patch_size)
    if patch_size < 1 or patch_size % 2 == 0 or len(steps) > MAX_STEPS:
        raise ValueError(f"unsupported geometry: search {search_size}, patch {patch_size}")
    b, h, w = f0.shape
    _check_grid(b, h, w)
    out = torch.empty((b, h, w, 2), dtype=torch.float32, device=f0.device)
    launch(
        "me_exact", "ocvk_me_exact", f0.device,
        f0.data_ptr(), f1.data_ptr(), None if seed is None else seed.data_ptr(), out.data_ptr(),
        (ctypes.c_int * max(len(steps), 1))(*steps), len(steps), b, h, w, patch_size,
        int(costfn == "ssd"), -1 if seed_bound is None else int(seed_bound),
        int(seed is not None and seed_mode == "shipped"),
        me_window_bytes(steps, patch_size, seed is not None, seed_bound),
    )
    return out


def _boxsum(img: torch.Tensor, patch_size: int) -> torch.Tensor:
    """Zero-padded patch sums over the last two dims (separable adds)."""
    pm = patch_size // 2
    h, w = img.shape[-2:]
    p = torch.nn.functional.pad(img, (0, 0, pm, pm))
    v = torch.zeros_like(img)
    for k in range(patch_size):
        v = v + p[..., k : k + h, :]
    p = torch.nn.functional.pad(v, (pm, pm, 0, 0))
    o = torch.zeros_like(img)
    for k in range(patch_size):
        o = o + p[..., k : k + w]
    return o


def _median3x3(a: torch.Tensor) -> torch.Tensor:
    """3x3 median over the last two dims with edge replication (Paeth's
    19-exchange network)."""
    h, w = a.shape[-2:]
    iy = torch.arange(-1, h + 1, device=a.device).clamp(0, h - 1)
    ix = torch.arange(-1, w + 1, device=a.device).clamp(0, w - 1)
    pd = a[..., iy, :][..., ix]
    v = [pd[..., j : j + h, i : i + w] for j in range(3) for i in range(3)]
    for i, j in MEDIAN9_EXCHANGES:
        v[i], v[j] = torch.minimum(v[i], v[j]), torch.maximum(v[i], v[j])
    return v[4]


def fast_round(
    f0: torch.Tensor, f1: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor, step: int,
    patch_size: int = 5, costfn: str = "sad",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of one round of the fast iteration before its median:
    warp frame 1 by the state (dy, dx) (zero outside the image), nine
    candidate costs at {-step, 0, step}^2 as zero-padded box sums of the
    shifted differences, and the state moved by the first minimum in
    row-major (dy, dx) order. Returns the moved state as int64 planes."""
    b, h, w = f0.shape
    ys, xs = _grid(h, w, f0.device)
    dy, dx = dy.to(torch.int64), dx.to(torch.int64)
    a = f0.to(torch.int32)
    w1 = gather_padded(f1, ys + dy, xs + dx).to(torch.int32)
    w1p = torch.nn.functional.pad(w1, (step, step, step, step))
    costs = []
    for oy in (-step, 0, step):
        for ox in (-step, 0, step):
            d = a - w1p[:, step + oy : step + oy + h, step + ox : step + ox + w]
            costs.append(_boxsum(d.abs() if costfn == "sad" else d * d, patch_size))
    best = _first_min(costs)
    return dy + (best // 3 - 1) * step, dx + (best % 3 - 1) * step


def me_fast(
    f0: torch.Tensor,
    f1: torch.Tensor,
    search_size: int = 15,
    patch_size: int = 5,
    costfn: str = "sad",
    init: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """Plain version of the fast iteration (``_fast_rounds``): per round
    (``fast_round``), warp frame 1 by the state (zero outside the image),
    nine candidate costs as zero-padded box sums of the shifted differences,
    first-minimum update, 3x3 median of both state planes. ``init`` = (dy,
    dx) integer [B, H, W] starts the state there instead of at zero. Returns
    the state as float32 [B, H, W, 2] (u = dx, v = dy)."""
    _check_frames(f0, f1, None)
    if costfn not in INT_COSTS:
        raise ValueError(f"costfn {costfn!r} requires method='exact'")
    if init is None:
        dy = torch.zeros(f0.shape, dtype=torch.int64, device=f0.device)
        dx = torch.zeros_like(dy)
    else:
        dy, dx = init
    for step in me_steps(search_size, patch_size):
        dy, dx = fast_round(f0, f1, dy, dx, step, patch_size, costfn)
        dy, dx = _median3x3(dy), _median3x3(dx)
    return torch.stack([dx.to(torch.float32), dy.to(torch.float32)], dim=-1)


def _check_fast(f0: torch.Tensor, f1: torch.Tensor, patch_size: int, costfn: str) -> None:
    require_cuda_tensor(f0, "f0", torch.uint8, 3)
    require_cuda_tensor(f1, "f1", torch.uint8, 3)
    _check_frames(f0, f1, None)
    if costfn not in INT_COSTS:
        raise ValueError(f"costfn {costfn!r} requires method='exact'")
    if patch_size < 1 or patch_size % 2 == 0 or patch_size > FAST_MAX_PATCH:
        raise ValueError(f"unsupported patch size {patch_size}: odd, at most {FAST_MAX_PATCH}")
    _check_grid(*f0.shape)


def _launch_round(f0, f1, dy, dx, out, patch_size: int, step: int, costfn: str) -> None:
    """One launch of ``csrc/me_fast_round.cu``: state (dy, dx) (None: zero)
    moved into the two planes of ``out``."""
    b, h, w = f0.shape
    launch(
        "me_fast_round", "ocvk_me_fast_round", f0.device,
        f0.data_ptr(), f1.data_ptr(),
        None if dy is None else dy.data_ptr(), None if dx is None else dx.data_ptr(),
        out[0].data_ptr(), out[1].data_ptr(), b, h, w, patch_size, step, int(costfn == "ssd"),
    )


def fast_round_kernel(
    f0: torch.Tensor, f1: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor, step: int,
    patch_size: int = 5, costfn: str = "sad",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Wrapper of one round: ``fast_round`` for CPU tensors; for CUDA
    tensors one launch of the round kernel, the state two contiguous int32
    [B, H, W] planes, the moved state returned as int32 planes."""
    if f0.device.type == "cpu":
        return fast_round(f0, f1, dy, dx, step, patch_size, costfn)
    _check_fast(f0, f1, patch_size, costfn)
    for name, t in (("dy", dy), ("dx", dx)):
        require_cuda_tensor(t, name, torch.int32, 3)
        if t.shape != f0.shape or t.device != f0.device:
            raise ValueError(f"{name} must be {tuple(f0.shape)} on {f0.device}")
    out = torch.empty((2, *f0.shape), dtype=torch.int32, device=f0.device)
    _launch_round(f0, f1, dy, dx, out, patch_size, step, costfn)
    return out[0], out[1]


def _launch_median(dy, dx, out, flow) -> None:
    """One launch of ``csrc/me_fast_median.cu``: the median of the state
    (dy, dx) into the two planes of ``out``, or, with ``flow``, into it."""
    b, h, w = dy.shape
    launch(
        "me_fast_median", "ocvk_me_fast_median", dy.device,
        dy.data_ptr(), dx.data_ptr(), None if flow is not None else out[0].data_ptr(),
        None if flow is not None else out[1].data_ptr(),
        None if flow is None else flow.data_ptr(), b, h, w,
    )


def median3x3_kernel(dy: torch.Tensor, dx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Wrapper of one median: ``_median3x3`` of both planes for CPU tensors;
    for CUDA tensors (two contiguous int32 [B, H, W] planes) one launch of
    the median kernel, the filtered state returned as int32 planes."""
    if dy.device.type == "cpu":
        return _median3x3(dy), _median3x3(dx)
    for name, t in (("dy", dy), ("dx", dx)):
        require_cuda_tensor(t, name, torch.int32, 3)
    if dx.shape != dy.shape or dx.device != dy.device:
        raise ValueError(f"dx {tuple(dx.shape)} must be dy's {tuple(dy.shape)} on {dy.device}")
    _check_grid(*dy.shape)
    out = torch.empty((2, *dy.shape), dtype=torch.int32, device=dy.device)
    _launch_median(dy, dx, out, None)
    return out[0], out[1]


def me_fast_kernel(
    f0: torch.Tensor,
    f1: torch.Tensor,
    search_size: int = 15,
    patch_size: int = 5,
    costfn: str = "sad",
    init: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """Wrapper: the plain version for CPU tensors; for CUDA tensors
    (contiguous [B, H, W] uint8, ``init`` two contiguous int32 [B, H, W]
    planes; odd patch sizes up to 31) one launch of the round kernel and one
    of the median kernel per step."""
    if f0.device.type == "cpu":
        return me_fast(f0, f1, search_size, patch_size, costfn, init)
    _check_fast(f0, f1, patch_size, costfn)
    b, h, w = f0.shape
    dev = f0.device
    dy = dx = None
    if init is not None:
        dy, dx = init
        for name, t in (("init dy", dy), ("init dx", dx)):
            require_cuda_tensor(t, name, torch.int32, 3)
            if t.shape != f0.shape or t.device != dev:
                raise ValueError(f"{name} must be {tuple(f0.shape)} on {dev}")
    steps = me_steps(search_size, patch_size)
    flow = torch.empty((b, h, w, 2), dtype=torch.float32, device=dev)
    if not steps:  # no round: the state as it came
        flow.zero_()
        if init is not None:
            flow.copy_(torch.stack([dx, dy], dim=-1))
        return flow
    # two pairs of state planes: a round reads one and writes the other (a
    # block reads its neighbours' state), the median the other way round
    moved = torch.empty((2, b, h, w), dtype=torch.int32, device=dev)
    state = torch.empty((2, b, h, w), dtype=torch.int32, device=dev)
    for r, step in enumerate(steps):
        _launch_round(f0, f1, dy, dx, moved, patch_size, step, costfn)
        _launch_median(moved[0], moved[1], state, flow if r == len(steps) - 1 else None)
        dy, dx = state[0], state[1]
    return flow
