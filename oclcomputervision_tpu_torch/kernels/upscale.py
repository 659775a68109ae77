"""Cheap bilinear upscale straight into parity planes.

Port of ``oclcomputervision_tpu/ops/pallas/upscale_pallas.py``
(``upscale_planes_pallas``). ``upscale_planes`` is the plain PyTorch version,
mirroring the XLA twin ``ops/raisr.upscale_planes``;
``upscale_planes_kernel`` is the wrapper over ``csrc/upscale_planes.cu``.

Both compute, per plane element, the same separately rounded f32 products
and sums in the same sorted-offset order; the kernel leaves out the offsets
whose weight is zero at that element (``compact_axis_table``), which adds
nothing for finite inputs, so it matches the plain version bit for bit.
Against the JAX twin the bound is 1 f32 ULP (XLA:CPU contracts multiply-adds
into FMAs).

Geometry: ``[B, h, w]`` f32 -> ``[B, s*s, hq, wq]`` f32 planes, origin
(hp, hp), edge-replicated outside the image. Unlike the TPU kernel there
are no zero tail rows past hq (a tile artefact no consumer reads).

A row band of a taller image (``row0``, ``h_img``: the band's first LR row
and the image's LR height) is upscaled at the image's coordinates: its row
stencil is the image's, rebased into the band, so its planes are rows of the
whole image's planes (the row-sharded RAISR, ``ops/raisr._raisr_band``).
Source rows outside the band clamp to its edge rows; they only reach plane
rows within the stencil's reach of the band's edges.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from oclcomputervision_tpu_torch.kernels._build import launch, require_cuda_tensor


def _axis_taps(n_in: int, s: int, org: int, n_out: int):
    """Per phase, the sorted (offset, weight vector) pairs of one axis."""
    from oclcomputervision_tpu_torch.ops.raisr import _phase_stencil_taps

    return [
        sorted(_phase_stencil_taps(n_in, s, a, org, n_out)[2].items())
        for a in range(s)
    ]


def upscale_planes(
    x01: torch.Tensor, cfg, hq: int, wq: int, hp: int, row0: int = 0, h_img: int | None = None
) -> torch.Tensor:
    """Plain version: [B, h, w] f32 -> [B, s*s, hq, wq] f32 parity planes
    (of a band from LR row ``row0`` of an ``h_img``-row image, if given)."""
    s = cfg.scale
    bsz, h, w = x01.shape
    h_img = h if h_img is None else h_img
    x = x01.to(torch.float32)
    dev = x.device
    row_taps = _axis_taps(h_img, s, hp - row0, hq)
    col_taps = _axis_taps(w, s, hp, wq)
    rows = torch.arange(hq, device=dev)
    cols = torch.arange(wq, device=dev)
    planes = []
    for a in range(s):
        # vertical pass: per-row weights, source rows clamped to the image
        v = torch.zeros((bsz, hq, w), dtype=torch.float32, device=dev)
        for d, wv in row_taps[a]:
            src = torch.clamp(torch.clamp(rows + d, 0, h_img - 1) - row0, 0, h - 1)
            v = v + torch.from_numpy(wv).to(dev)[:, None] * x[:, src, :]
        for b in range(s):
            # horizontal pass: per-column weights
            o = torch.zeros((bsz, hq, wq), dtype=torch.float32, device=dev)
            for d, wv in col_taps[b]:
                src = torch.clamp(cols + d, 0, w - 1)
                o = o + torch.from_numpy(wv).to(dev)[None, :] * v[:, :, src]
            planes.append(o)
    return torch.stack(planes, dim=1)


# csrc/upscale_planes.cu's tile: plane rows x columns per block, and the LR
# rows x columns it stages for them (the C entry point refuses any other)
TILE = (8, 128)
SPAN = (TILE[0] + 4, TILE[1] + 4)


def compact_axis_table(n_in: int, s: int, org: int, n_out: int, tile: int, span: int):
    """One axis of the stencil as the kernel reads it: source indices
    ``idx`` [2, s, n_out] int32 (clamped to the image, first <= second) and
    weights ``wgt`` [2, s, n_out] f32, such that the plain version's sum
    over a phase's sorted offsets equals
    ``wgt[0] * x[idx[0]] + wgt[1] * x[idx[1]]`` bit for bit: at most two
    offsets carry a non-zero weight at any one index, the others add
    ``0 * x = +0``. Where one offset carries it all, the second tap repeats
    the first with weight 0.

    Raises if an index decreases along the axis or a ``tile`` of plane
    indices reaches ``span`` or more source pixels: the kernel stages
    ``span`` of them from the first index of the tile's first element."""
    idx = np.zeros((2, s, n_out), np.int32)
    wgt = np.zeros((2, s, n_out), np.float32)
    j = np.arange(n_out)
    for a, taps in enumerate(_axis_taps(n_in, s, org, n_out)):
        offs = np.array([d for d, _ in taps])
        dense = np.stack([wv for _, wv in taps])  # [offsets, n_out], sorted
        live = dense != 0
        count = live.sum(0)
        if count.min() < 1 or count.max() > 2:
            raise ValueError(f"upscale stencil with {count.min()}-{count.max()} taps")
        first = live.argmax(0)
        last = len(taps) - 1 - live[::-1].argmax(0)
        for k, pick in enumerate((first, last)):
            idx[k, a] = np.clip(j + offs[pick], 0, n_in - 1)
            wgt[k, a] = dense[pick, j]
        wgt[1, a][count == 1] = 0.0
    if (np.diff(idx, axis=2) < 0).any() or (idx[0] > idx[1]).any():
        raise ValueError("upscale source indices decrease along the axis")
    starts = np.arange(0, n_out, tile)
    ends = np.minimum(starts + tile, n_out) - 1
    reach = idx[1][:, ends].max(0) - idx[0][:, starts].min(0)
    if reach.max() >= span:
        raise ValueError(f"a tile of {tile} reaches {reach.max() + 1} > {span} source pixels")
    return idx, wgt


COMPILED_SCALES = (2, 3, 4)  # csrc/upscale_planes.cu's compiled forms


def upscale_form(s: int) -> str:
    """The launch count a scale's upscale goes to: the compiled form at
    scales 2-4, the generic form (scale read at run time) at any other."""
    return "upscale_planes" if s in COMPILED_SCALES else "upscale_planes_generic"


def band_row_table(h: int, s: int, hp: int, hq: int, row0: int, h_img: int):
    """The row table of an h-row band from LR row ``row0`` of an
    ``h_img``-row image: the image's table at the band's plane rows, its
    indices rebased into the band and clamped to it."""
    idx, wgt = compact_axis_table(h_img, s, hp - row0, hq, TILE[0], SPAN[0])
    return np.clip(idx - row0, 0, h - 1).astype(np.int32), wgt


@functools.lru_cache(maxsize=16)
def _device_tables(
    h: int, w: int, s: int, hp: int, hq: int, wq: int, device, row0: int = 0, h_img=None
):
    """Row and column compact tables (idx, wgt, idx, wgt) on the device."""
    tabs = band_row_table(h, s, hp, hq, row0, h if h_img is None else h_img) + (
        compact_axis_table(w, s, hp, wq, TILE[1], SPAN[1])
    )
    return tuple(torch.from_numpy(t).to(device) for t in tabs)


def upscale_planes_kernel(
    x01: torch.Tensor, cfg, hq: int, wq: int, hp: int, row0: int = 0, h_img: int | None = None
) -> torch.Tensor:
    """Wrapper: the plain version for a CPU tensor, the CUDA kernel for a
    CUDA tensor (contiguous [B, h, w] f32, wq a multiple of 4): the form
    compiled for the scale at scales 2-4, the generic form at any other."""
    if x01.device.type == "cpu":
        return upscale_planes(x01, cfg, hq, wq, hp, row0, h_img)
    require_cuda_tensor(x01, "x01", torch.float32, 3)
    s = cfg.scale
    nimg, h, w = x01.shape
    if s < 1 or wq % 4 or h * w >= 2**31:
        raise ValueError(
            f"the CUDA upscale kernel takes scales >= 1 and plane widths that are "
            f"multiples of 4, got scale {s}, wq {wq}, image {h} x {w}"
        )
    tabs = _device_tables(h, w, s, hp, hq, wq, x01.device, row0, h_img)
    out = torch.empty((nimg, s * s, hq, wq), dtype=torch.float32, device=x01.device)
    launch(
        upscale_form(s), "ocvk_upscale_planes", x01.device,
        x01.data_ptr(), out.data_ptr(), *(t.data_ptr() for t in tabs),
        nimg, h, w, s, hq, wq, *TILE, *SPAN,
    )
    return out
