"""NumPy oracle for align-corners bilinear interpolation: the part of the
JAX package's ``oracle/interpolation.py`` that the port calls.

Matches the reference's bilinear LDS kernel (basic/interpolation.cl:17-70
bilinear_lds): align-corners coordinate mapping src_x = out_x/(Wout-1)*(Win-1)
(interpolation.cl:58,92) with clamp-to-edge addressing. The bicubic path and
the other coordinate mappings stay in the JAX package until a slice needs
them.
"""

from __future__ import annotations

import numpy as np


def _axis_coords(n_out: int, n_in: int, dtype=np.float64):
    """Align-corners source coordinate of each output sample."""
    o = np.arange(n_out, dtype=dtype)
    # interpolation.cl:58,92 (the explicit LDS kernels)
    return o / (n_out - 1) * (n_in - 1) if n_out > 1 else np.zeros(1, dtype)


def axis_weights(n_out: int, n_in: int, method: str = "bilinear", dtype=np.float64):
    """Linear taps: returns (idx [n_out, 2], w [n_out, 2]).

    Clamp-to-edge: out-of-range taps clamp to the border pixel; where
    both taps coincide the fractional weight cancels, so no weight
    zeroing is needed (matches both the CL sampler and cv2 borders).
    """
    if method != "bilinear":
        raise ValueError(f"unknown method {method!r}")
    x = _axis_coords(n_out, n_in, dtype)
    x0 = np.floor(x)
    u = (x - x0).astype(dtype)
    i0 = x0.astype(np.int64)
    idx = np.stack([i0, np.clip(i0 + 1, 0, n_in - 1)], axis=1)
    idx = np.clip(idx, 0, n_in - 1)
    w = np.stack([1 - u, u], axis=1)
    return idx, w


def resize_align_corners(
    img: np.ndarray, out_hw, method: str = "bilinear", dtype=np.float64
) -> np.ndarray:
    """Separable align-corners bilinear resize of [H, W] or [H, W, C];
    float in the input's value range."""
    in_float = np.asarray(img, dtype=dtype)
    squeeze = in_float.ndim == 2
    if squeeze:
        in_float = in_float[..., None]
    h_in, w_in = in_float.shape[:2]
    h_out, w_out = out_hw

    yidx, yw = axis_weights(h_out, h_in, method, dtype)
    xidx, xw = axis_weights(w_out, w_in, method, dtype)

    # vertical pass: [h_out, w_in, C]
    tmp = np.einsum("okwc,ok->owc", in_float[yidx], yw)
    # horizontal pass: [h_out, w_out, C]
    out = np.einsum("ohkc,hk->ohc", tmp[:, xidx, :], xw)
    if squeeze:
        out = out[..., 0]
    return out
