"""NumPy oracle for align-corners bilinear/bicubic interpolation.

Matches the reference's well-defined LDS kernel variants
(basic/interpolation.cl:17-70 bilinear_lds, :132-211 bicubic_lds):
- align-corners coordinate mapping: src_x = out_x/(Wout-1)*(Win-1)
  (interpolation.cl:58,92)
- clamp-to-edge addressing
- bicubic = 4x4 Catmull-Rom with a=-0.5 basis (cubic_matrix,
  interpolation.cl:73-78), output clamped to the valid range
  (interpolation.cl:128,209).

The reference's bilinear_simple is NOT bit-identical to bilinear_lds
(SURVEY.md fidelity note 11): it feeds an align-corners normalized
coordinate to the HW sampler (interpolation.cl:11), which samples at
u * W_in - 0.5 with linear filtering and clamp-to-edge. That numerics is
available here as ``mapping="hw_sampler"``; ``mapping="half_pixel"`` is
the cv2.INTER_LINEAR convention ((o + 0.5) * W_in/W_out - 0.5). The
default ``mapping="align_corners"`` matches the LDS kernels, which is
also what the reference's own PSNR harness treats as ground truth.
"""

from __future__ import annotations

import numpy as np


def _axis_coords(n_out: int, n_in: int, mapping: str, dtype=np.float64):
    """Source coordinate of each output sample under the given mapping."""
    o = np.arange(n_out, dtype=dtype)
    if mapping == "align_corners":
        # interpolation.cl:58,92 (the explicit LDS kernels)
        return o / (n_out - 1) * (n_in - 1) if n_out > 1 else np.zeros(1, dtype)
    if mapping == "hw_sampler":
        # interpolation.cl:11: align-corners normalized coordinate through
        # the linear-filtering sampler (implicit -0.5 texel offset)
        u = o / (n_out - 1) if n_out > 1 else np.zeros(1, dtype)
        return u * n_in - 0.5
    if mapping == "half_pixel":
        # cv2.INTER_LINEAR convention
        return (o + 0.5) * (n_in / n_out) - 0.5
    raise ValueError(f"unknown mapping {mapping!r}")


def _axis_weights_linear(
    n_out: int, n_in: int, dtype=np.float64, mapping: str = "align_corners"
):
    """Linear taps: returns (idx [n_out, 2], w [n_out, 2]).

    Clamp-to-edge: out-of-range taps clamp to the border pixel; where
    both taps coincide the fractional weight cancels, so no weight
    zeroing is needed (matches both the CL sampler and cv2 borders).
    """
    x = _axis_coords(n_out, n_in, mapping, dtype)
    x0 = np.floor(x)
    u = (x - x0).astype(dtype)
    i0 = x0.astype(np.int64)
    idx = np.stack([i0, np.clip(i0 + 1, 0, n_in - 1)], axis=1)
    idx = np.clip(idx, 0, n_in - 1)
    w = np.stack([1 - u, u], axis=1)
    return idx, w


def cubic_weights(u: np.ndarray, dtype=np.float64) -> np.ndarray:
    """Catmull-Rom (a=-0.5) weights for taps at offsets {-1,0,1,2}.

    Same polynomials as the cubic_matrix dot products in
    interpolation.cl:101-117: w[j] = dot((1,u,u^2,u^3), M[j]).
    """
    u = np.asarray(u, dtype=dtype)
    u2 = u * u
    u3 = u2 * u
    w0 = -0.5 * u + u2 - 0.5 * u3
    w1 = 1.0 - 2.5 * u2 + 1.5 * u3
    w2 = 0.5 * u + 2.0 * u2 - 1.5 * u3
    w3 = -0.5 * u2 + 0.5 * u3
    return np.stack([w0, w1, w2, w3], axis=-1)


def _axis_weights_cubic(
    n_out: int, n_in: int, dtype=np.float64, mapping: str = "align_corners"
):
    """Catmull-Rom taps: (idx [n_out, 4], w [n_out, 4])."""
    x = _axis_coords(n_out, n_in, mapping, dtype)
    x0 = np.floor(x)
    u = x - x0
    base = x0.astype(np.int64) - 1
    idx = np.clip(base[:, None] + np.arange(4)[None, :], 0, n_in - 1)
    return idx, cubic_weights(u, dtype=dtype)


def axis_weights(
    n_out: int,
    n_in: int,
    method: str,
    dtype=np.float64,
    mapping: str = "align_corners",
):
    if method == "bilinear":
        return _axis_weights_linear(n_out, n_in, dtype, mapping)
    if method == "bicubic":
        return _axis_weights_cubic(n_out, n_in, dtype, mapping)
    raise ValueError(f"unknown method {method!r}")


def resize_align_corners(
    img: np.ndarray,
    out_hw,
    method: str = "bilinear",
    dtype=np.float64,
    mapping: str = "align_corners",
) -> np.ndarray:
    """Separable resize of [H, W] or [H, W, C] (default align-corners).

    Returns float in the input's value range. Bicubic output is clamped
    to [0, 255] for uint8 inputs / [0, 1] for float inputs in [0, 1]
    (matching interpolation.cl:128's clamp on UNORM data).
    """
    in_float = np.asarray(img, dtype=dtype)
    squeeze = in_float.ndim == 2
    if squeeze:
        in_float = in_float[..., None]
    h_in, w_in = in_float.shape[:2]
    h_out, w_out = out_hw

    yidx, yw = axis_weights(h_out, h_in, method, dtype, mapping)
    xidx, xw = axis_weights(w_out, w_in, method, dtype, mapping)

    # vertical pass: [h_out, w_in, C]
    tmp = np.einsum("okwc,ok->owc", in_float[yidx], yw)
    # horizontal pass: [h_out, w_out, C]
    out = np.einsum("ohkc,hk->ohc", tmp[:, xidx, :], xw)

    if method == "bicubic":
        hi = 255.0 if np.issubdtype(np.asarray(img).dtype, np.integer) else 1.0
        out = np.clip(out, 0.0, hi)
    if squeeze:
        out = out[..., 0]
    return out


def resize_uint8(
    img: np.ndarray, out_hw, method: str = "bilinear", mapping: str = "align_corners"
) -> np.ndarray:
    """uint8-in/uint8-out resize with round-to-nearest quantization."""
    out = resize_align_corners(img, out_hw, method, mapping=mapping)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)
