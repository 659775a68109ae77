"""A stdlib-only PNG reader (zlib + struct) for the repository's assets.

Reads 8-bit, non-interlaced, colour-type-2 (RGB) PNGs, which is what every
PNG in ``assets/`` is, so the port needs neither cv2 nor PIL.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from oclcomputervision_tpu_torch.utils.assets import asset_path

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _unfilter(raw: bytes, h: int, w: int) -> np.ndarray:
    """Undo the per-row PNG filters of RGB8 scanlines -> [h, w, 3] uint8.

    Paeth and Average predict from the left, upper and upper-left pixels,
    so pixel (y, x) depends only on pixels of smaller y + x: one vectorised
    step per anti-diagonal reconstructs the image.
    """
    rows = np.frombuffer(raw, np.uint8).reshape(h, 1 + 3 * w)
    ftype = rows[:, 0].astype(np.int32)
    if ftype.max() > 4:
        raise ValueError(f"unknown PNG filter type {ftype.max()}")
    data = rows[:, 1:].reshape(h, w, 3).astype(np.int32)
    # one zero row above and one zero column to the left: the PNG's
    # out-of-image neighbours
    rec = np.zeros((h + 1, w + 1, 3), np.int32)
    for t in range(h + w - 1):
        y = np.arange(max(0, t - w + 1), min(h, t + 1))
        x = t - y
        a = rec[y + 1, x]  # left
        b = rec[y, x + 1]  # up
        c = rec[y, x]  # up-left
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        ft = ftype[y][:, None]
        pred = np.select(
            [ft == 1, ft == 2, ft == 3, ft == 4],
            [a, b, (a + b) >> 1, paeth],
            default=0,
        )
        rec[y + 1, x + 1] = (data[y, x] + pred) & 255
    return rec[1:, 1:].astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit non-interlaced RGB PNG -> [H, W, 3] uint8."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG")
    pos = 8
    header = None
    idat = []
    while pos < len(buf):
        (length,) = struct.unpack(">I", buf[pos : pos + 4])
        ctype = buf[pos + 4 : pos + 8]
        body = buf[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, _comp, _filt, interlace = header
    if (depth, color, interlace) != (8, 2, 0):
        raise ValueError(
            f"{path}: only 8-bit non-interlaced RGB is supported, got depth "
            f"{depth}, colour type {color}, interlace {interlace}"
        )
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != h * (1 + 3 * w):
        raise ValueError(f"{path}: {len(raw)} bytes of scanlines for {w}x{h}")
    return _unfilter(raw, h, w)


def gray(rgb: np.ndarray) -> np.ndarray:
    """BT.601 luma of [H, W, 3] uint8 RGB, rounded (the formula of
    ``oclcomputervision_tpu.utils.assets.load_gray``'s PIL path)."""
    x = rgb.astype(np.float64)
    y = 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]
    return np.round(y).clip(0, 255).astype(np.uint8)


def gray_libpng(rgb: np.ndarray) -> np.ndarray:
    """The luma libpng computes when it decodes RGB to gray with BT.601
    weights (``png_set_rgb_to_gray``): 15-bit fixed-point weights 9797, 19234
    and 3737, the sum TRUNCATED, so about half the pixels come out one level
    below ``gray``. It is what ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)``
    returns for a PNG without a gamma chunk, and so what the JAX package's
    ``load_gray`` gives where cv2 is installed: its published quality
    numbers on the Middlebury frames were taken on this decode."""
    x = rgb.astype(np.int64)
    return ((9797 * x[..., 0] + 19234 * x[..., 1] + 3737 * x[..., 2]) >> 15).astype(np.uint8)


def load_image(name: str) -> np.ndarray:
    """An asset (or an absolute path) as RGB uint8 [H, W, 3]."""
    return read_png(name if os.path.isabs(name) else asset_path(name))


def load_gray(name: str, libpng: bool = False) -> np.ndarray:
    """An asset (or an absolute path) as BT.601 luma uint8 [H, W]: rounded
    (``gray``), or with ``libpng=True`` truncated as libpng and
    ``cv2.imread(..., IMREAD_GRAYSCALE)`` decode it (``gray_libpng``)."""
    rgb = load_image(name)
    return gray_libpng(rgb) if libpng else gray(rgb)
