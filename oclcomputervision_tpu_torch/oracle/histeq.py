"""NumPy oracle for global and local-block histogram equalization.

Reproduces the observable behavior of the reference's CPU paths:
- calc_transfer_func: histeq/eq_global.py:10-37 (CDF -> punch ->
  alpha-blend with identity -> clip [0,255] -> gain limit [I/clip, I*clip]).
  Note eq_global.py:26-28 is dead code (overwritten at :31) and the final
  LUT entry 0 always maps to 0 (gain limit collapses to [0, 0] at I=0).
- histeq_global: eq_global.py:39-62 (uint8 LUT, truncating cast).
- histeq_local_block: eq_local_block.py:10-78. The CPU and GPU paths are
  numerically equivalent (trunc-toward-zero block indexing, s/t clamped
  at 0 (CPU) / [0,1] (GPU, hist.cl:135-136 — upper clamp never binds for
  in-range pixels), bilinear blend of 4 block LUTs, truncating uint8 cast).
- hist_grid: the tiled histogram layout of hist.cl:41-90 /
  eq_opencl.py:37-51 — grid[h/th, w/tw, 256] of per-tile histograms.
"""

from __future__ import annotations

import numpy as np


def calc_transfer_func(
    hist: np.ndarray,
    alpha: float,
    punch: float,
    clip: float,
    dtype=np.float64,
) -> np.ndarray:
    """Build the 256-entry float transfer function (LUT), range [0, 255].

    ``dtype`` selects the accumulation precision: float64 matches the
    reference CPU path exactly; float32 matches the TPU op bit-for-bit.
    """
    hist = np.asarray(hist, dtype=dtype)
    n = hist.shape[0]
    idx = np.arange(n, dtype=dtype)

    cdf = np.cumsum(hist) / np.sum(hist)

    # punch: find the quantile gray levels, re-normalize CDF between them
    dark_punch = int(np.argmax(cdf >= punch))
    bright_punch = int(np.argmax(cdf >= 1 - punch))
    hist_punched = hist[dark_punch:bright_punch]
    cdf = cdf.copy()
    cdf[:dark_punch] = 0
    cdf[bright_punch:] = 1
    s = np.sum(hist_punched)
    cdf[dark_punch:bright_punch] = np.cumsum(hist_punched) / s

    # alpha-blend with the identity ramp, clip, gain-limit
    mapping = alpha * cdf * 255 + (1 - alpha) * idx
    mapping = np.clip(mapping, 0, 255)
    mapping = np.clip(mapping, idx / clip, idx * clip)
    return mapping.astype(np.float32)


def clip_histogram(hist: np.ndarray, clip_limit: float) -> np.ndarray:
    """CLAHE contrast limiting: cap bins at ``clip_limit`` * mean-count
    and redistribute the excess uniformly (single pass, cv2-style).

    The reference never implemented this - it only benchmarked against
    cv2.createCLAHE (histeq_test.py:61); this is the capability filled in.
    """
    hist = np.asarray(hist, dtype=np.float64)
    limit = clip_limit * hist.sum() / hist.shape[0]
    clipped = np.minimum(hist, limit)
    excess = hist.sum() - clipped.sum()
    return clipped + excess / hist.shape[0]


def hist_grid(gray: np.ndarray, tile=(32, 256), bins: int = 256) -> np.ndarray:
    """Per-tile histogram grid, uint32 [H//th, W//tw, bins].

    Tile (th, tw) defaults to the reference workgroup coverage (32 rows x
    256 cols, eq_opencl.py:43-44). H, W must be divisible by the tile.
    """
    th, tw = tile
    h, w = gray.shape
    assert h % th == 0 and w % tw == 0, (gray.shape, tile)
    gh, gw = h // th, w // tw
    tiles = gray.reshape(gh, th, gw, tw).transpose(0, 2, 1, 3).reshape(gh, gw, th * tw)
    out = np.zeros((gh, gw, bins), dtype=np.uint32)
    for i in range(gh):
        for j in range(gw):
            out[i, j] = np.bincount(tiles[i, j], minlength=bins).astype(np.uint32)
    return out


def histeq_global(
    gray: np.ndarray,
    alpha: float = 1.0,
    punch: float = 0.05,
    clip: float = 2.0,
    dtype=np.float64,
) -> np.ndarray:
    """Global histogram equalization (eq_global.py:39-62, CPU path)."""
    hist, _ = np.histogram(gray, bins=256, range=(0, 256))
    mapping = calc_transfer_func(hist, alpha, punch, clip, dtype=dtype).astype(np.uint8)
    return mapping[gray]


def histeq_local_block(
    gray: np.ndarray,
    alpha: float = 0.5,
    punch: float = 0.05,
    clip: float = 3.0,
    blockshape=(256, 256),
    dtype=np.float64,
    clahe_clip: float = 0.0,
) -> np.ndarray:
    """Local-block (CLAHE-style) histeq (eq_local_block.py:10-78).

    Vectorized but numerically identical to the reference's per-pixel
    Python loop (which mutates its input in place; we return a copy).
    """
    block_h, block_w = blockshape
    h, w = gray.shape
    nby, nbx = h // block_h, w // block_w

    mappings = np.zeros((nby, nbx, 256), dtype=np.float32)
    for i in range(nby):
        for j in range(nbx):
            blk = gray[i * block_h : (i + 1) * block_h, j * block_w : (j + 1) * block_w]
            bh, _ = np.histogram(blk, bins=256, range=(0, 256))
            if clahe_clip > 0:
                bh = clip_histogram(bh, clahe_clip)
            mappings[i, j, :] = calc_transfer_func(bh, alpha, punch, clip, dtype=dtype)

    return apply_block_mappings(gray, mappings, blockshape)


def apply_block_mappings(
    gray: np.ndarray, mappings: np.ndarray, blockshape=(256, 256)
) -> np.ndarray:
    """Bilinear blend of the 4 nearest block LUTs per pixel.

    Matches hist.cl:104-147: trunc-toward-zero block indexing from the
    block centers, s/t in block units clamped to [0,1], neighbor indices
    clamped to the grid, float32 blend, truncating uint8 cast.
    """
    nby, nbx = mappings.shape[:2]
    block_h, block_w = blockshape
    h, w = gray.shape

    ix = np.arange(w)
    iy = np.arange(h)
    # C-style int division truncates toward zero: x - bw//2 >= -bw//2 > -bw
    # so the quotient is 0 for the left half-block, matching int()/C `/`.
    b00x_idx = np.trunc((ix - block_w // 2) / block_w).astype(np.int64)
    b00y_idx = np.trunc((iy - block_h // 2) / block_h).astype(np.int64)
    b00x = b00x_idx * block_w + block_w // 2
    b00y = b00y_idx * block_h + block_h // 2

    b01x_idx = np.minimum(b00x_idx + 1, nbx - 1)
    b10y_idx = np.minimum(b00y_idx + 1, nby - 1)

    s = np.clip((ix - b00x).astype(np.float32) / np.float32(block_w), 0.0, 1.0)
    t = np.clip((iy - b00y).astype(np.float32) / np.float32(block_h), 0.0, 1.0)

    v = gray  # [h, w] uint8
    f00 = mappings[b00y_idx[:, None], b00x_idx[None, :], v]
    f01 = mappings[b00y_idx[:, None], b01x_idx[None, :], v]
    f10 = mappings[b10y_idx[:, None], b00x_idx[None, :], v]
    f11 = mappings[b10y_idx[:, None], b01x_idx[None, :], v]

    ss = s[None, :].astype(np.float32)
    tt = t[:, None].astype(np.float32)
    out = (1 - ss) * (1 - tt) * f00 + ss * (1 - tt) * f01 + (1 - ss) * tt * f10 + ss * tt * f11
    return np.clip(out, 0.0, 255.0).astype(np.uint8)
