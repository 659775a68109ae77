"""NumPy oracle for pyramidal dense block-matching motion estimation.

Faithful (vectorized) reimplementation of the reference's per-pixel
Python search (motion_estimation/me_pyramid.py:130-205):

For every pixel, a patch_size^2 patch of frame0 (zero-padded at borders,
me_pyramid.py:89-127) is matched in frame1 by a shrinking-step log
search: step starts at search_size//2 - patch_size//2 and halves each
round (5 -> 2 -> 1 for the 15/5 defaults, me_pyramid.py:146-157). Each
round evaluates a 3x3 grid of candidate offsets {-step, 0, +step}^2 by
SAD (float32 of uint8 diffs, me_pyramid.py:36-41) with first-minimum
tie-breaking in row-major (dy, dx) scan order, then recenters.

Seed semantics (fidelity quirk, me_pyramid.py:136-137 + 197-198): the
search centers at p + int(seed), but the found displacement d —
which already includes int(seed) — is then ADDED to mv (= seed.copy()),
so the integer part of the seed is double-counted in the output.
``seed_mode='shipped'`` reproduces that; ``seed_mode='fixed'`` returns
seed-consistent flow (total displacement from p, i.e. int(seed) + search
deltas plus the seed's fractional part is dropped intentionally — the
search itself is integer).
"""

from __future__ import annotations

import numpy as np


def gaussian2d(shape=(3, 3), sigma=0.5) -> np.ndarray:
    """MATLAB fspecial('gaussian')-style mask (me_pyramid.py:15-27)."""
    m, n = [(ss - 1.0) / 2.0 for ss in shape]
    y, x = np.ogrid[-m : m + 1, -n : n + 1]
    h = np.exp(-(x * x + y * y) / (2.0 * sigma * sigma))
    h[h < np.finfo(h.dtype).eps * h.max()] = 0
    sumh = h.sum()
    if sumh != 0:
        h /= sumh
    return h


def patch_cost(p0: np.ndarray, p1: np.ndarray, costfn: str = "sad") -> np.ndarray:
    """Block-match cost over the last two axes (me_pyramid.py:29-48).

    p0/p1: float32 [..., ps, ps]. 'sad' is the only cost the reference
    search actually uses (me_pyramid.py:70); 'ssd' matches its SSD();
    'wsad_shipped' reproduces WSAD()'s quirk - np.dot(patch, weights) is
    a MATMUL, not elementwise weighting (SURVEY.md fidelity note 9) -
    and 'wsad' is the evidently intended elementwise version.
    """
    if costfn == "sad":
        return np.abs(p0 - p1).sum(axis=(-2, -1))
    if costfn == "ssd":
        d = p0 - p1
        return (d * d).sum(axis=(-2, -1))
    if costfn in ("wsad_shipped", "wsad"):
        w = gaussian2d(p0.shape[-2:], 2.0).astype(np.float32)
        if costfn == "wsad_shipped":
            return np.abs(p0 @ w - p1 @ w).sum(axis=(-2, -1))
        return (np.abs(p0 - p1) * w).sum(axis=(-2, -1))
    raise ValueError(f"unknown costfn {costfn!r}")


# Paeth's 19-exchange median-of-9 sorting network (exchange pairs).
# Shared by the XLA fast path (ops/motion.median3x3) and the fused
# Pallas fast kernel (ops/pallas/me_fast_pallas.py) - the two must stay
# identical, it encodes part of their bit-identity contract.
MEDIAN9_EXCHANGES = (
    (1, 2), (4, 5), (7, 8), (0, 1), (3, 4), (6, 7), (1, 2), (4, 5),
    (7, 8), (0, 3), (5, 8), (4, 7), (3, 6), (1, 4), (2, 5), (4, 7),
    (4, 2), (6, 4), (4, 2),
)


def me_steps(search_size: int, patch_size: int):
    """Shrinking step schedule: searchMargin-patchMargin, halving to 1."""
    step = search_size // 2 - patch_size // 2
    steps = []
    while step >= 1:
        steps.append(step)
        step //= 2
    return steps


def _gather_padded(img: np.ndarray, yy: np.ndarray, xx: np.ndarray) -> np.ndarray:
    """img[yy, xx] with zeros outside the image (me_pyramid.py:89-127)."""
    h, w = img.shape
    valid = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
    vals = img[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)]
    return np.where(valid, vals, 0).astype(np.float32)


def estimate_motion_vector(
    gray0: np.ndarray,
    gray1: np.ndarray,
    search_size: int = 15,
    patch_size: int = 5,
    seed: np.ndarray | None = None,
    seed_mode: str = "shipped",
    costfn: str = "sad",
) -> np.ndarray:
    """Dense integer block-matching flow [H, W, 2] (u=x, v=y), float32."""
    h, w = gray0.shape
    pm = patch_size // 2
    f0 = gray0.astype(np.float32)
    f1 = gray1.astype(np.float32)

    ys, xs = np.mgrid[0:h, 0:w]
    if seed is None:
        seed_u = np.zeros((h, w), np.float32)
        seed_v = np.zeros((h, w), np.float32)
    else:
        seed_u = seed[..., 0].astype(np.float32)
        seed_v = seed[..., 1].astype(np.float32)

    cy = ys + np.trunc(seed_v).astype(np.int64)
    cx = xs + np.trunc(seed_u).astype(np.int64)

    # frame0 patches, zero-padded: [H, W, ps, ps]
    offs = np.arange(patch_size) - pm
    patches = _gather_padded(
        f0,
        ys[:, :, None, None] + offs[None, None, :, None],
        xs[:, :, None, None] + offs[None, None, None, :],
    )

    for step in me_steps(search_size, patch_size):
        sads = np.empty((9, h, w), np.float32)
        k = 0
        for dy in (-step, 0, step):
            for dx in (-step, 0, step):
                cand = _gather_padded(
                    f1,
                    (cy + dy)[:, :, None, None] + offs[None, None, :, None],
                    (cx + dx)[:, :, None, None] + offs[None, None, None, :],
                )
                sads[k] = patch_cost(patches, cand, costfn)
                k += 1
        best = np.argmin(sads, axis=0)  # first min = row-major (dy, dx) order
        cy = cy + (best // 3 - 1) * step
        cx = cx + (best % 3 - 1) * step

    du = (cx - xs).astype(np.float32)
    dv = (cy - ys).astype(np.float32)
    if seed_mode == "shipped":
        u = seed_u + du
        v = seed_v + dv
    elif seed_mode == "fixed":
        u, v = du, dv
    else:
        raise ValueError(seed_mode)
    return np.stack([u, v], axis=-1)


def resize_bilinear_halfpixel(img: np.ndarray, out_hw) -> np.ndarray:
    """cv2.INTER_LINEAR-style resize (half-pixel centers, clamped taps).

    Used by upscale_mv to match me_test.py:57-62, which calls cv2.resize
    on float flow components.
    """
    h_in, w_in = img.shape[:2]
    h_out, w_out = out_hw
    out_dt = np.float64

    def taps(n_out, n_in):
        x = (np.arange(n_out, dtype=out_dt) + 0.5) * (n_in / n_out) - 0.5
        x0 = np.floor(x)
        u = x - x0
        i0 = x0.astype(np.int64)
        # cv2 clamps the source coordinate, zeroing the weight overhang
        u = np.where(i0 < 0, 0.0, u)
        u = np.where(i0 >= n_in - 1, 1.0, u)
        i0 = np.clip(i0, 0, n_in - 1)
        i1 = np.clip(i0 + 1, 0, n_in - 1)
        return i0, i1, u

    y0, y1, vy = taps(h_out, h_in)
    x0, x1, ux = taps(w_out, w_in)
    a = img.astype(out_dt)
    rows = a[y0] * (1 - vy)[:, None] + a[y1] * vy[:, None]
    out = rows[:, x0] * (1 - ux)[None, :] + rows[:, x1] * ux[None, :]
    return out.astype(img.dtype if np.issubdtype(img.dtype, np.floating) else np.float32)


def upscale_mv(mv: np.ndarray, scale: int, mode: str = "shipped") -> np.ndarray:
    """Upscale a flow field for coarse-to-fine seeding (me_test.py:51-63).

    'shipped' reproduces the reference exactly: each component is divided
    by its (signed) max, bilinearly resized with cv2 half-pixel
    convention, then multiplied back by max*scale. That normalization is
    wrong for all-negative components and divides by zero when max == 0
    (SURVEY.md fidelity note 8). 'fixed' simply resizes and multiplies by
    scale.
    """
    h, w = mv.shape[:2]
    u = mv[..., 0].astype(np.float32)
    v = mv[..., 1].astype(np.float32)
    if mode == "shipped":
        u_max = np.max(u)
        v_max = np.max(v)
        u = resize_bilinear_halfpixel(u / u_max, (h * scale, w * scale)) * (u_max * scale)
        v = resize_bilinear_halfpixel(v / v_max, (h * scale, w * scale)) * (v_max * scale)
    elif mode == "fixed":
        u = resize_bilinear_halfpixel(u, (h * scale, w * scale)) * scale
        v = resize_bilinear_halfpixel(v, (h * scale, w * scale)) * scale
    else:
        raise ValueError(mode)
    return np.stack([u, v], axis=-1)
