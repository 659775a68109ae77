"""Wrapper over ``csrc/resize_sep.cu``: the separable bilinear / bicubic
resize of ``ops/interpolation`` in one launch.

``ops.interpolation._resize_passes`` is the plain version: rows then columns,
per tap an ``index_select``, a multiply and an add. The kernel computes, per
output element, the same separately rounded f32 products and sums in the
same order (its source says how), so the two agree bit for bit; it reads the
input in its own type (uint8 or f32) and stores f32 or uint8, with the
bicubic clamp and the quantisation of ``ops.resize_uint8`` in the store.

``tile_plan`` sizes a block's tile and its shared-memory window from the
shapes alone: the tables may be a band's rows (``ops.raisr._raisr_shipped``)
that live on the card. A block whose tables reach past the window computes
from device memory directly, so the plan is a matter of speed, not of
correctness.
"""

from __future__ import annotations

import math

import torch

from oclcomputervision_tpu_torch.kernels._build import launch

TILE_H = 24  # output rows a tile has, at most (the kernel takes up to 32)
TILE_W = 256  # flattened output elements (pixels x channels) a tile has, at most
# bytes of window and row pass a block may hold: 4 blocks an SM at the
# enhance call's 48.6 KB
SMEM_BUDGET = 64 * 1024


def axis_span(n_in: int, n_out: int, taps: int, tile: int) -> int:
    """Most source indices ``tile`` consecutive outputs of an axis reach,
    under any of the three mappings: the source coordinate advances by at
    most n_in / (n_out - 1) an output, a floor adds one, the taps ``taps``
    - 1 and the f32 coordinates one more."""
    step = n_in / max(n_out - 1, 1)
    return min(n_in, math.floor((tile - 1) * step) + taps + 2)


def tile_plan(h_in: int, w_in: int, h_out: int, w_out: int, nch: int, taps: int,
              in_bytes: int) -> tuple:
    """(tile_h, tile_w, span_h, pitch) of a launch: the tile in output rows
    and flattened output elements, and the window a block stages, in input
    rows and in elements of a row (a multiple of 16 bytes; the row pass
    takes tile_h rows of pitch f32). ``span_h`` 0 is the direct form
    everywhere, taken where an axis shrinks by ``taps`` or more (the window
    would hold pixels no tap reads) or no tile fits SMEM_BUDGET."""
    if h_in >= taps * h_out or w_in >= taps * w_out:
        return TILE_H, TILE_W, 0, 0
    unit = 16 // in_bytes
    tile_h, tile_w = TILE_H, TILE_W
    while True:
        span_h = axis_span(h_in, h_out, taps, tile_h)
        span_w = axis_span(w_in, w_out, taps, (tile_w - 1) // nch + 2)
        # the window's start is aligned down to 16 bytes: up to unit - 1 more
        pitch = -(-(span_w * nch + unit - 1) // unit) * unit
        if span_h * pitch * in_bytes + tile_h * pitch * 4 <= SMEM_BUDGET:
            return tile_h, tile_w, span_h, pitch
        if tile_h > 1:
            tile_h //= 2
        elif tile_w > 32:
            tile_w //= 2
        else:
            return TILE_H, TILE_W, 0, 0


def _check_table(idx: torch.Tensor, wgt: torch.Tensor, n_out: int, device, name: str) -> None:
    if (idx.dtype != torch.int64 or wgt.dtype != torch.float32 or idx.ndim != 2
            or idx.shape != wgt.shape or idx.shape[0] not in (2, 4) or idx.shape[1] != n_out):
        raise ValueError(
            f"{name} must be int64 indices and f32 weights of shape [2 or 4, {n_out}], got "
            f"{idx.dtype} {tuple(idx.shape)} and {wgt.dtype} {tuple(wgt.shape)}")
    if idx.device != device or wgt.device != device:
        raise ValueError(f"{name} must be on {device}")
    if not (idx.is_contiguous() and wgt.is_contiguous()):
        raise ValueError(f"{name} must be contiguous")


def resize_sep(x: torch.Tensor, rows, cols, out_dtype: torch.dtype = torch.float32,
               clamp_hi: float | None = None) -> torch.Tensor:
    """Resize contiguous CUDA [B, H, W, C] uint8 or f32 ``x`` by the axis
    tables ``rows`` and ``cols`` (each (int64 indices, f32 weights), [taps,
    n_out], taps 2 or 4, on ``x``'s device) into a new [B, h_out, w_out, C]
    tensor of ``out_dtype`` (f32 or uint8). ``clamp_hi``: clamp to [0,
    clamp_hi] before the store (the bicubic clamp); a uint8 output is then
    rounded half to even and clamped to [0, 255]."""
    if x.dtype not in (torch.uint8, torch.float32) or x.ndim != 4:
        raise ValueError(f"x must be uint8 or float32 [B, H, W, C], got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.device.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor, got device {x.device}")
    if out_dtype not in (torch.uint8, torch.float32):
        raise ValueError(f"out_dtype must be uint8 or float32, got {out_dtype}")
    nimg, h_in, w_in, nch = x.shape
    (yidx, yw), (xidx, xw) = rows, cols
    h_out, w_out = yidx.shape[-1], xidx.shape[-1]
    _check_table(yidx, yw, h_out, x.device, "rows")
    _check_table(xidx, xw, w_out, x.device, "cols")
    if min(h_in, w_in, nch) < 1:
        raise ValueError(f"x has no pixels to resize: {tuple(x.shape)}")
    out = torch.empty((nimg, h_out, w_out, nch), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    taps = yidx.shape[0]
    if xidx.shape[0] != taps:
        raise ValueError(f"rows have {taps} taps, cols {xidx.shape[0]}")
    if max(h_in * w_in, h_out * w_out) * nch >= 2**31:
        raise ValueError(f"an image of {h_in} x {w_in} -> {h_out} x {w_out} x {nch} is too large")
    in_bytes = x.element_size()
    plan = tile_plan(h_in, w_in, h_out, w_out, nch, taps, in_bytes)
    vec_in = int(x.data_ptr() % 16 == 0 and (w_in * nch * in_bytes) % 16 == 0)
    launch(
        "resize_sep", "ocvk_resize_sep", x.device,
        x.data_ptr(), out.data_ptr(), yidx.data_ptr(), yw.data_ptr(), xidx.data_ptr(),
        xw.data_ptr(), nimg, h_in, w_in, h_out, w_out, nch, taps,
        int(x.dtype == torch.uint8), int(out_dtype == torch.uint8),
        *plan, vec_in,
        int(clamp_hi is not None), 0.0 if clamp_hi is None else float(clamp_hi),
    )
    return out
