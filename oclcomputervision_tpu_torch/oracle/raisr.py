"""NumPy oracle for RAISR super-resolution.

The reference (super_resolution/raisr.{py,cl}) implements RAISR
(arXiv:1606.01299) as one fused OpenCL kernel: cheap bilinear upscale ->
RGB->YUV -> Sobel gradients -> 9x9 Gaussian-weighted structure tensor ->
(angle, strength, coherence, pixel-type) hash -> per-pixel 11x11 learned
filter -> YUV->RGB.

Fidelity modes:
- 'shipped': reproduces the reference's observable output. An `#if 1`
  early-return (raisr.cl:219-230) makes the shipped kernel emit the
  bilinear upscale after a YUV roundtrip; stages 4-6 are dead code.
- 'full': the intended pipeline with the reference's kernel bugs fixed
  (SURVEY.md fidelity notes 2-4): structure tensor accumulates gx*gx /
  gx*gy / gy*gy (not gx*gy three times, raisr.cl:271-273), the coherence
  bucket quantizes coherence (not L1, raisr.cl:308-314), and the hash
  includes strength_idx (raisr.cl:316 drops it). Gradients are the Sobel
  correlation (the reference kernel's CONV3x3 flips the kernel,
  raisr.cl:42-46; sign is irrelevant to the tensor, orientation is
  consistent between our trainer and inference).

Constants (CSC matrices, Sobel taps, 9x9 sigma=2 Gaussian, strength /
coherence quantizers) match raisr.py:20-47,80-82,112-114.
"""

from __future__ import annotations

import numpy as np

from oclcomputervision_tpu_torch.oracle.interpolation import resize_align_corners
from oclcomputervision_tpu_torch.utils.config import RaisrConfig

RGB2YUV = np.array(
    [
        [0.299, 0.587, 0.114],
        [-0.14713, -0.28886, 0.436],
        [0.615, -0.51499, -0.10001],
    ],
    dtype=np.float64,
)
YUV2RGB = np.array(
    [
        [1.0, 0.0, 1.13983],
        [1.0, -0.39465, -0.58060],
        [1.0, 2.03211, 0.0],
    ],
    dtype=np.float64,
)
SOBEL_X = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], dtype=np.float64)
SOBEL_Y = np.array([[-1, -2, -1], [0, 0, 0], [1, 2, 1]], dtype=np.float64)


def gaussian2d(shape=(9, 9), sigma=2.0) -> np.ndarray:
    """MATLAB fspecial-style normalized Gaussian (raisr.py:48-60)."""
    m, n = [(s - 1.0) / 2.0 for s in shape]
    y, x = np.ogrid[-m : m + 1, -n : n + 1]
    h = np.exp(-(x * x + y * y) / (2.0 * sigma * sigma))
    h[h < np.finfo(h.dtype).eps * h.max()] = 0
    return h / h.sum()


def _correlate2d_valid(img: np.ndarray, kern: np.ndarray) -> np.ndarray:
    kh, kw = kern.shape
    out = np.zeros((img.shape[0] - kh + 1, img.shape[1] - kw + 1), img.dtype)
    for i in range(kh):
        for j in range(kw):
            out += kern[i, j] * img[i : i + out.shape[0], j : j + out.shape[1]]
    return out


def cheap_upscale(img01: np.ndarray, scale: int) -> np.ndarray:
    """Bilinear align-corners upscale (linear_sample path, raisr.cl:48-61)."""
    h, w = img01.shape[:2]
    return resize_align_corners(img01, (h * scale, w * scale), "bilinear")


def hash_image(up_y: np.ndarray, cfg: RaisrConfig) -> np.ndarray:
    """Per-pixel (angle, strength, coherence) bucket index [H, W] int32.

    up_y: upscaled luma in [0, 1]. The 11x11-filter margin is handled by
    edge replication (== the reference's clamp-to-edge sampling).
    """
    g = cfg.gauss_len // 2  # structure-tensor window margin (4)
    pad = g + 1  # +1 for the Sobel taps
    y = np.pad(up_y.astype(np.float64), pad, mode="edge")
    gx = _correlate2d_valid(y, SOBEL_X)  # margin g remains
    gy = _correlate2d_valid(y, SOBEL_Y)

    w = gaussian2d((cfg.gauss_len, cfg.gauss_len), cfg.gauss_sigma)
    a = _correlate2d_valid(gx * gx, w)
    b = _correlate2d_valid(gx * gy, w)
    d = _correlate2d_valid(gy * gy, w)

    t = a + d
    det = a * d - b * b
    disc = np.sqrt(np.maximum(t * t / 4.0 - det, 0.0))
    l1 = t / 2.0 + disc
    l2 = t / 2.0 - disc

    theta = np.arctan2(b, l1 - d)
    theta = np.where(theta < 0, theta + np.pi, theta)

    sq1 = np.sqrt(np.maximum(l1, 0.0))
    sq2 = np.sqrt(np.maximum(l2, 0.0))
    denom = sq1 + sq2
    coherence = np.where(denom != 0, (sq1 - sq2) / np.where(denom == 0, 1, denom), 0.0)

    angle_idx = np.clip(
        (theta / np.pi * cfg.num_angle).astype(np.int32), 0, cfg.num_angle - 1
    )
    strength_idx = np.digitize(l1, cfg.strength_quantizers).astype(np.int32)
    coherence_idx = np.digitize(coherence, cfg.coherence_quantizers).astype(np.int32)

    return (
        angle_idx * cfg.num_strength + strength_idx
    ) * cfg.num_coherence + coherence_idx


def pixel_type_map(h: int, w: int, scale: int) -> np.ndarray:
    """(y % scale) * scale + (x % scale) per output pixel (raisr.cl:297)."""
    yy, xx = np.mgrid[0:h, 0:w]
    return ((yy % scale) * scale + (xx % scale)).astype(np.int32)


def filter_index(bucket: np.ndarray, ptype: np.ndarray, cfg: RaisrConfig) -> np.ndarray:
    return bucket * cfg.num_pixel_type + ptype


def apply_filters(
    up: np.ndarray, fidx: np.ndarray, filters: np.ndarray, cfg: RaisrConfig
) -> np.ndarray:
    """Per-pixel 11x11 filter, applied to every channel (raisr.cl:322-330)."""
    fl = cfg.filter_len
    m = fl // 2
    squeeze = up.ndim == 2
    x = up[..., None] if squeeze else up
    xp = np.pad(x, ((m, m), (m, m), (0, 0)), mode="edge")
    h, w = up.shape[:2]
    sel = filters.reshape(-1, fl, fl)[fidx]  # [H, W, fl, fl]
    out = np.zeros_like(x, dtype=np.float64)
    for i in range(fl):
        for j in range(fl):
            out += sel[:, :, i, j, None] * xp[i : i + h, j : j + w]
    return out[..., 0] if squeeze else out


# 8-neighbor ring in circular (clockwise) order for the census
# transform's local change count
CT_RING = ((-1, -1), (-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1), (0, -1))


def ct_blend_weights(up_y: np.ndarray) -> np.ndarray:
    """Per-pixel filtered-output weight in [0, 1] from the census
    transform of the cheap-upscaled luma (RAISR paper arXiv:1606.01299
    §V "blending"; the reference kernel has no blending stage).

    The 3x3 census transform bits b_k = (neighbor_k >= center) are read
    around the ring in circular order; the local change count
    LCC = #{k : b_k != b_(k+1 mod 8)} measures structure: a flat patch
    or a single clean edge gives LCC <= 2 (contiguous runs), randomness
    (noise) gives high LCC. The filtered output gets full weight on
    structure and fades to the cheap upscale as randomness rises:
    w = clip((8 - LCC) / 6, 0, 1) (LCC is even by ring parity, so the
    realized weights are {1, 1, 2/3, 1/3, 0} for LCC {0, 2, 4, 6, 8}).
    Boundaries are edge-replicated (replicated neighbors tie as >=,
    which reads as structure - boundary pixels keep the filter).
    """
    xp = np.pad(up_y, 1, mode="edge")
    h, w = up_y.shape
    bits = [
        xp[1 + dr : 1 + dr + h, 1 + dc : 1 + dc + w] >= up_y
        for dr, dc in CT_RING
    ]
    lcc = np.zeros((h, w), np.int32)
    for k in range(8):
        lcc += bits[k] != bits[(k + 1) % 8]
    return np.clip((8.0 - lcc) / 6.0, 0.0, 1.0)


def raisr_upsample(
    img: np.ndarray,
    filters: np.ndarray | None,
    cfg: RaisrConfig = RaisrConfig(),
) -> np.ndarray:
    """RAISR 2x upsample of uint8 [H, W] (gray) or [H, W, 3] (RGB).

    Returns uint8 at scale x the input size. fidelity from cfg.
    """
    gray = img.ndim == 2
    x01 = img.astype(np.float64) / 255.0
    up = cheap_upscale(x01, cfg.scale)

    if gray:
        yuv = up[..., None]
    else:
        yuv = up @ RGB2YUV.T

    if cfg.fidelity == "shipped":
        out = yuv[..., 0] if gray else yuv @ YUV2RGB.T
    else:
        bucket = hash_image(yuv[..., 0], cfg)
        ptype = pixel_type_map(*yuv.shape[:2], cfg.scale)
        fidx = filter_index(bucket, ptype, cfg)
        filtered = apply_filters(yuv if not gray else yuv[..., 0], fidx, filters, cfg)
        if cfg.blend == "ct":
            # the luma-derived structure weight blends every channel
            # (each channel got the same per-pixel filter, so the same
            # artifact-suppression weight applies)
            wgt = ct_blend_weights(yuv[..., 0])
            cheap = yuv[..., 0] if gray else yuv
            if not gray:
                wgt = wgt[..., None]
            filtered = wgt * filtered + (1.0 - wgt) * cheap
        out = filtered if gray else filtered @ YUV2RGB.T

    return np.clip(np.rint(out * 255.0), 0, 255).astype(np.uint8)
