"""NumPy oracle for the Gaussian pyramid.

The reference builds pyramids with cv2.pyrDown (pyramid/pyramid.py:7-14):
a 5x5 binomial ([1,4,6,4,1]/16 separable) Gaussian blur with
BORDER_REFLECT_101 edges followed by 2x decimation at even indices,
with the COARSEST level at index 0.
"""

from __future__ import annotations

import numpy as np

PYR_KERNEL_1D = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0


def _reflect101_pad(img: np.ndarray, pad: int, axis: int) -> np.ndarray:
    return np.pad(
        img,
        [(pad, pad) if a == axis else (0, 0) for a in range(img.ndim)],
        mode="reflect",
    )


def _conv1d(img: np.ndarray, axis: int) -> np.ndarray:
    pad = 2
    x = _reflect101_pad(img.astype(np.float64), pad, axis)
    out = np.zeros_like(img, dtype=np.float64)
    n = img.shape[axis]
    sl = [slice(None)] * img.ndim
    for k, w in enumerate(PYR_KERNEL_1D):
        sl[axis] = slice(k, k + n)
        out += w * x[tuple(sl)]
    return out


def pyr_down(img: np.ndarray, scale: int = 2) -> np.ndarray:
    """One pyramid level: 5x5 binomial blur + decimate (cv2.pyrDown semantics).

    Output size floor(H/scale) x floor(W/scale), sampling the blurred image
    at indices 0, scale, 2*scale, ... For uint8 input, rounds to nearest.
    """
    blurred = _conv1d(_conv1d(img, 0), 1)
    out = blurred[::scale, ::scale][: img.shape[0] // scale, : img.shape[1] // scale]
    if np.issubdtype(img.dtype, np.integer):
        return np.clip(np.rint(out), 0, 255).astype(img.dtype)
    return out.astype(img.dtype)


def gaussian_pyramid(img: np.ndarray, scale: int = 2, depth: int = 3):
    """List of ``depth`` levels, index 0 = coarsest (pyramid.py:9-14)."""
    pyramid = [img]
    src = img
    for _ in range(depth - 1):
        src = pyr_down(src, scale)
        pyramid.insert(0, src)
    return pyramid
