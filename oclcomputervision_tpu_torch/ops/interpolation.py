"""Align-corners bilinear/bicubic interpolation in PyTorch.

Port of ``oclcomputervision_tpu/ops/interpolation.py``. Separable resize as
two passes, rows then columns; each pass is ``out = out + w_k * x[idx_k]``
over the taps k in order, with the f32 index and weight tables of the numpy
oracle's ``axis_weights``: the JAX package's f32 operations in its order.
No TPU kernel stands behind it (the JAX resize is plain jnp). On the card one
hand-written kernel, ``kernels/csrc/resize_sep.cu`` (``kernels.resize``),
computes the same products and sums in the same order in one launch, from
the input's type to the output's, casts and quantisation included; the
torch passes (``_resize_passes``) are the plain version, for CPU tensors.
Semantics match the reference's explicit LDS kernels
(basic/interpolation.cl:17-70, 132-211): align-corners mapping,
clamp-to-edge, Catmull-Rom a=-0.5 (cubic_matrix, interpolation.cl:73-78),
bicubic output clamped to the valid range (interpolation.cl:128).
``F.interpolate`` is not the same function: its bicubic uses a = -0.75 and
no mode of it gives ``hw_sampler``.

``mapping`` selects the coordinate convention: "align_corners"
(default, the LDS kernels), "hw_sampler" (the reference's
bilinear_simple: align-corners normalized coordinate through the HW
sampler's implicit -0.5 texel offset, interpolation.cl:11-13 - NOT
bit-identical to the LDS variant, SURVEY.md fidelity note 11), or
"half_pixel" (cv2.INTER_LINEAR pixel centers).

Numpy inputs run on the card unless ``device="cpu"`` is passed; a torch
tensor runs on its own device.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from oclcomputervision_tpu_torch._device import as_tensor
from oclcomputervision_tpu_torch.kernels.resize import resize_sep
from oclcomputervision_tpu_torch.ops._layout import rank3_is_batched
from oclcomputervision_tpu_torch.oracle.interpolation import axis_weights


@functools.lru_cache(maxsize=64)
def _axis_table(n_out: int, n_in: int, method: str, mapping: str, device: torch.device):
    """Per tap k, source indices [taps, n_out] int64 and f32 weights
    [taps, n_out] on ``device``."""
    idx, wgt = axis_weights(n_out, n_in, method, dtype=np.float32, mapping=mapping)
    return (torch.from_numpy(np.ascontiguousarray(idx.T)).to(device),
            torch.from_numpy(np.ascontiguousarray(wgt.T)).to(device))


def _tables(img, out_hw, method, mapping, rows):
    """The (row, column) tables of resizing [B, H, W, C] ``img`` to out_hw."""
    h_out, w_out = out_hw
    _, h_in, w_in, _ = img.shape
    yx = rows if rows is not None else _axis_table(h_out, h_in, method, mapping, img.device)
    return yx, _axis_table(w_out, w_in, method, mapping, img.device)


def _resize_plane(
    img: torch.Tensor,
    out_hw: Tuple[int, int],
    method: str,
    mapping: str = "align_corners",
    rows: Tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """Resize float [B, H, W, C] -> [B, h_out, w_out, C]. ``rows``, if given,
    replaces the row pass's table: (indices, weights), each [taps, h_out]
    (a band's rows of a taller image's table, ``ops.raisr._raisr_shipped``).
    The plain passes for a CPU tensor, the kernel for a CUDA tensor."""
    if img.device.type == "cpu":
        return _resize_passes(img, out_hw, method, mapping, rows)
    return resize_sep(img.contiguous(), *_tables(img, out_hw, method, mapping, rows))


def _resize_passes(
    img: torch.Tensor,
    out_hw: Tuple[int, int],
    method: str,
    mapping: str = "align_corners",
    rows: Tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """Plain version of ``_resize_plane``: the row pass, then the column
    pass, per tap an ``index_select``, a multiply and an add."""
    bsz, h_in, w_in, nch = img.shape
    h_out, w_out = out_hw
    (yidx, yw), (xidx, xw) = _tables(img, out_hw, method, mapping, rows)

    out = torch.zeros((bsz, h_out, w_in, nch), dtype=img.dtype, device=img.device)
    for k in range(yw.shape[0]):
        out = out + yw[k][None, :, None, None] * img.index_select(1, yidx[k])

    out2 = torch.zeros((bsz, h_out, w_out, nch), dtype=img.dtype, device=img.device)
    for k in range(xw.shape[0]):
        out2 = out2 + xw[k][None, None, :, None] * out.index_select(2, xidx[k])
    return out2


def _channels_last(x: torch.Tensor, batched):
    """[H, W], [H, W, C], [B, H, W] or [B, H, W, C] as a [B, H, W, C] view,
    and the function that gives an output back the input's layout."""
    if x.ndim == 2:
        return x[None, ..., None], lambda o: o[0, ..., 0]
    if x.ndim == 3:
        if rank3_is_batched(x.shape, batched, "resize"):
            return x[..., None], lambda o: o[..., 0]
        return x[None], lambda o: o[0]
    if x.ndim == 4:
        return x, lambda o: o
    raise ValueError(f"unsupported rank {x.ndim}")


def _resize(img, out_hw, method, mapping, batched, device, out_dtype) -> torch.Tensor:
    x = as_tensor(img, device)
    clamp_hi = 1.0 if x.dtype.is_floating_point else 255.0
    out_hw = tuple(int(v) for v in out_hw)
    if x.device.type == "cpu":
        x4, unpack = _channels_last(x.to(torch.float32), batched)
        out = _resize_plane(x4, out_hw, method, mapping)
        if method == "bicubic":
            out = torch.clamp(out, 0.0, clamp_hi)
        if out_dtype == torch.uint8:
            out = torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
        return unpack(out)
    # the kernel reads uint8 and f32 as they are, other types as f32
    x4, unpack = _channels_last(x, batched)
    if x4.dtype not in (torch.uint8, torch.float32):
        x4 = x4.to(torch.float32)
    x4 = x4.contiguous()
    out = resize_sep(x4, *_tables(x4, out_hw, method, mapping, None), out_dtype,
                     clamp_hi if method == "bicubic" else None)
    return unpack(out)


def resize(
    img,
    out_hw: Tuple[int, int],
    method: str = "bilinear",
    mapping: str = "align_corners",
    batched=None,
    *,
    device=None,
) -> torch.Tensor:
    """Resize of [H, W], [H, W, C], [B, H, W], or [B, H, W, C] to out_hw.

    Float32 output in the input's value range ([0, 255] for uint8 input).
    See the module docstring for the ``mapping`` conventions.
    Rank-3 layout: ``batched=None`` (default) reads a trailing dim <= 4
    as channels and raises on anything wider; True forces a [B, H, W]
    luma stack, False forces [H, W, C] (ops/_layout.py).
    """
    return _resize(img, out_hw, method, mapping, batched, device, torch.float32)


def resize_uint8(
    img,
    out_hw: Tuple[int, int],
    method: str = "bilinear",
    mapping: str = "align_corners",
    batched=None,
    *,
    device=None,
) -> torch.Tensor:
    """uint8-in/uint8-out resize with round-to-nearest quantization (half
    to even, as ``jnp.round``)."""
    return _resize(img, out_hw, method, mapping, batched, device, torch.uint8)


def bilinear(img, out_hw, *, device=None) -> torch.Tensor:
    """Reference-named alias (basic/interpolation.py:37): the reference's
    ``bilinear`` method dispatches bilinear_simple, whose HW-sampler
    numerics ``mapping="hw_sampler"`` reproduces."""
    return resize_uint8(img, out_hw, "bilinear", mapping="hw_sampler", device=device)


def bilinear_lds(img, out_hw, *, device=None) -> torch.Tensor:
    """Reference-named alias (basic/interpolation.py:73): explicit
    align-corners math (interpolation.cl:39-70)."""
    return resize_uint8(img, out_hw, "bilinear", device=device)


def bicubic(img, out_hw, *, device=None) -> torch.Tensor:
    """Reference-named alias (basic/interpolation.py:55)."""
    return resize_uint8(img, out_hw, "bicubic", device=device)
