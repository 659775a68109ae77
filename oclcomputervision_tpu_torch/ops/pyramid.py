"""Gaussian pyramid in PyTorch.

Port of ``oclcomputervision_tpu/ops/pyramid.py``: cv2.pyrDown semantics, a
5x5 binomial blur ([1, 4, 6, 4, 1] / 16, separable) with reflect-101 borders
followed by decimation, coarsest level at index 0. The JAX package has no
Pallas kernel here, so the port is torch ops: scale 2 runs the JAX side's
parity-plane form in its order of operations, other scales a strided
``conv2d``. For uint8 input every product and sum is exact in float32 (the
weights are multiples of 1/16), so the levels equal JAX's bit for bit;
``torch.round`` and ``jnp.round`` both round half to even.

Numpy inputs run on the card unless ``device="cpu"`` is passed; a torch
tensor stays on its own device.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from oclcomputervision_tpu_torch._device import as_tensor
from oclcomputervision_tpu_torch.ops._layout import rank3_is_batched

_K1D = np.array([1.0, 4.0, 6.0, 4.0, 1.0], dtype=np.float32) / 16.0
_K2D = np.outer(_K1D, _K1D)  # separable binomial, same as cv2.pyrDown


def _pyr_down_2x(x: torch.Tensor) -> torch.Tensor:
    """One level at scale 2: [N, H, W] float32 -> [N, H//2, W//2].

    Parity-plane shift-adds: taps at even offsets {-2, 0, +2} read the
    even-row plane, odd offsets {-1, +1} the odd plane."""
    k0, k1, k2 = (float(_K1D[0]), float(_K1D[1]), float(_K1D[2]))
    n, m = x.shape[1] // 2, x.shape[2] // 2
    xp = F.pad(x[:, None], (2, 2, 2, 2), mode="reflect")[:, 0]  # reflect-101
    e, o = xp[:, 0::2], xp[:, 1::2]
    v = k0 * (e[:, :n] + e[:, 2 : n + 2]) + k2 * e[:, 1 : n + 1] + k1 * (o[:, :n] + o[:, 1 : n + 1])
    ve, vo = v[:, :, 0::2], v[:, :, 1::2]
    return (
        k0 * (ve[:, :, :m] + ve[:, :, 2 : m + 2])
        + k2 * ve[:, :, 1 : m + 1]
        + k1 * (vo[:, :, :m] + vo[:, :, 1 : m + 1])
    )


def _pyr_down_f32(x: torch.Tensor, scale: int) -> torch.Tensor:
    """One level: [N, H, W] float32 -> [N, H//scale, W//scale]."""
    h, w = x.shape[1:]
    if h < 3 or w < 3:
        raise ValueError(f"pyr_down needs at least 3x3 pixels, got {h}x{w}")
    if scale == 2:
        return _pyr_down_2x(x)
    xp = F.pad(x[:, None], (2, 2, 2, 2), mode="reflect")
    kern = torch.from_numpy(_K2D).to(x.device)[None, None]
    # full float32 products on the card (cuDNN would take TF32 by default)
    with torch.backends.cudnn.flags(allow_tf32=False):
        out = F.conv2d(xp, kern, stride=scale)[:, 0]
    return out[:, : h // scale, : w // scale]


def _pyr_down(img: torch.Tensor, scale: int, batched) -> torch.Tensor:
    if img.ndim == 3:
        batched = rank3_is_batched(img.shape, batched, "pyr_down")
    elif img.ndim not in (2, 4):
        raise ValueError(f"pyr_down takes 2 to 4 dims, got {tuple(img.shape)}")
    # planes [N, H, W]: channels-last inputs move their channels in front
    if img.ndim == 2:
        planes = img[None]
    elif img.ndim == 3 and batched:
        planes = img
    elif img.ndim == 3:
        planes = img.permute(2, 0, 1)
    else:
        b, h, w, c = img.shape
        planes = img.permute(0, 3, 1, 2).reshape(b * c, h, w)
    out = _pyr_down_f32(planes.to(torch.float32), scale)
    if not (img.dtype.is_floating_point or img.dtype.is_complex):
        out = torch.clamp(torch.round(out), 0, 255)
    out = out.to(img.dtype)
    if img.ndim == 2:
        return out[0]
    if img.ndim == 3:
        return out if batched else out.permute(1, 2, 0)
    return out.reshape(b, c, *out.shape[1:]).permute(0, 2, 3, 1)


def pyr_down(img, scale: int = 2, batched=None, *, device=None) -> torch.Tensor:
    """Blur + decimate one level; uint8 in -> uint8 out (round to nearest,
    half to even).

    Accepts [H, W], [H, W, C], [B, H, W], or [B, H, W, C]. Rank-3 layout:
    ``batched=None`` (default) reads a trailing dim <= 4 as channels and
    raises on anything wider; True forces [B, H, W], False forces
    [H, W, C] (ops/_layout.py).
    """
    return _pyr_down(as_tensor(img, device), scale, batched)


def gaussian_pyramid(
    img, scale: int = 2, depth: int = 3, batched=None, *, device=None
) -> List[torch.Tensor]:
    """List of ``depth`` levels, index 0 = COARSEST (pyramid.py:9-14).

    ``batched`` disambiguates rank-3 inputs exactly as in pyr_down.
    """
    src = as_tensor(img, device)
    if src.ndim == 3:
        # resolve once so every level below is unambiguous
        batched = rank3_is_batched(src.shape, batched, "gaussian_pyramid")
    pyramid = [src]
    for _ in range(depth - 1):
        src = _pyr_down(src, scale, batched)
        pyramid.insert(0, src)
    return pyramid
