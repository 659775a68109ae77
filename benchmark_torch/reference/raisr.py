"""Plain PyTorch RAISR upsampling of gray uint8 images, ``fidelity='full'``.

The algorithm of Romano, Isidoro and Milanfar, "RAISR" (IEEE TCI 2017,
arXiv:1606.01299), as the configuration states it, written from its
equations in the image domain and independent of the program under test:

1. x = lr / 255 in float32; the cheap upscale is the align-corners bilinear
   resize to s H x s W (source coordinate o (n_in - 1) / (n_out - 1)),
   taken outside the image as the edge pixel;
2. the hash of each HR pixel: Sobel gradients of the edge-padded upscale,
   the structure tensor (gx gx, gx gy, gy gy) blurred by the separable
   gauss_len x gauss_len Gaussian of sigma gauss_sigma (rows, then columns),
   its eigenvalues l1 >= l2, the angle atan2(b, l1 - d) in [0, pi) cut into
   num_angle buckets, the strength l1 and the coherence
   (sqrt l1 - sqrt l2) / (sqrt l1 + sqrt l2) against their quantizers;
3. filter index (bucket * s * s + pixel type), pixel type
   (y mod s) * s + (x mod s);
4. the filter's fl x fl taps over the edge-padded upscale, the taps and
   the bank rounded to ``apply_dtype`` (bfloat16 as stated: products exact
   in float32) and summed in float32 in row-major tap order;
5. round half to even of 255 * the sum, clamped to [0, 255].

``stage_dtype`` rounds the upscale (and so the hash's input) to a lower
precision where the control asks for it; float32 leaves it as stated. The
apply runs in blocks of rows, so that an image of any size fits.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

SOBEL_X = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))
SOBEL_Y = ((-1.0, -2.0, -1.0), (0.0, 0.0, 0.0), (1.0, 2.0, 1.0))
APPLY_ROWS = 256  # HR rows per block of the apply


def load_bank(path: str):
    """(filters [n, fl, fl] float32 numpy, (num_angle, num_strength,
    num_coherence, filter_len, scale)) of a ``.npz`` bank."""
    with np.load(path) as z:
        return z["filters"].astype(np.float32), tuple(int(v) for v in z["cfg"])


def rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to ``dtype`` and back to float32 (x itself for float32)."""
    return x if dtype == torch.float32 else x.to(dtype).to(torch.float32)


def div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d as a correctly rounded float32 division (a Python divisor on
    CUDA would multiply by its reciprocal)."""
    return x / torch.tensor(d, dtype=torch.float32, device=x.device)


def axis_taps(n_out: int, n_in: int, device):
    """Align-corners bilinear taps of one axis: indices i0, i1 [n_out] and
    float32 weights w0, w1, coordinates computed in float64."""
    o = np.arange(n_out, dtype=np.float64)
    src = o * (n_in - 1) / (n_out - 1) if n_out > 1 else np.zeros(1)
    i0 = np.floor(src).astype(np.int64)
    u = src - i0
    i1 = np.minimum(i0 + 1, n_in - 1)
    t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a).astype(dt)).to(device)
    return t(i0, np.int64), t(i1, np.int64), t(1.0 - u, np.float32), t(u, np.float32)


def cheap_upscale(x01: torch.Tensor, s: int) -> torch.Tensor:
    """[B, H, W] float32 -> the align-corners bilinear [B, sH, sW]: rows,
    then columns, each w0 x[i0] + w1 x[i1]."""
    _, h, w = x01.shape
    r0, r1, rw0, rw1 = axis_taps(s * h, h, x01.device)
    c0, c1, cw0, cw1 = axis_taps(s * w, w, x01.device)
    rows = rw0[None, :, None] * x01[:, r0] + rw1[None, :, None] * x01[:, r1]
    return cw0 * rows[:, :, c0] + cw1 * rows[:, :, c1]


def gaussian_1d(gauss_len: int, sigma: float) -> np.ndarray:
    """The 1D factor k of the normalised gauss_len^2 Gaussian window w2d
    (MATLAB's fspecial): outer(k, k) == w2d, k = w2d[g] / sqrt(w2d[g, g])."""
    m = (gauss_len - 1) / 2.0
    y, x = np.ogrid[-m : m + 1, -m : m + 1]
    w2d = np.exp(-(x * x + y * y) / (2.0 * sigma * sigma))
    w2d[w2d < np.finfo(w2d.dtype).eps * w2d.max()] = 0
    w2d = w2d / w2d.sum()
    g = gauss_len // 2
    return w2d[g] / np.sqrt(w2d[g, g])


def _correlate3(y: torch.Tensor, kern) -> torch.Tensor:
    """'valid' 3 x 3 correlation of [B, H, W], taps in row-major order."""
    h, w = y.shape[1] - 2, y.shape[2] - 2
    out = None
    for u in range(3):
        for v in range(3):
            if kern[u][v] != 0.0:
                term = kern[u][v] * y[:, u : u + h, v : v + w]
                out = term if out is None else out + term
    return out


def hash_buckets(up: torch.Tensor, cfg: dict) -> torch.Tensor:
    """Bucket (angle, strength, coherence) of every pixel of the upscale
    [B, H, W] float32 -> int64 [B, H, W]."""
    gl = cfg["gauss_len"]
    g = gl // 2
    y = F.pad(up[:, None], (g + 1,) * 4, mode="replicate")[:, 0]
    gx = _correlate3(y, SOBEL_X)
    gy = _correlate3(y, SOBEL_Y)
    k1 = [float(np.float32(v)) for v in gaussian_1d(gl, cfg["gauss_sigma"])]
    h, w = up.shape[1:]
    blurred = []
    for t in (gx * gx, gx * gy, gy * gy):
        v = None
        for u in range(gl):
            term = k1[u] * t[:, u : u + h, :]
            v = term if v is None else v + term
        hsum = None
        for u in range(gl):
            term = k1[u] * v[:, :, u : u + w]
            hsum = term if hsum is None else hsum + term
        blurred.append(hsum)
    a, b, d = blurred
    pi = torch.tensor(np.pi, dtype=torch.float32, device=up.device)
    tr = a + d
    det = a * d - b * b
    disc = torch.sqrt(torch.clamp(div(tr * tr, 4.0) - det, min=0.0))
    l1 = div(tr, 2.0) + disc
    l2 = div(tr, 2.0) - disc
    theta = torch.atan2(b, l1 - d)
    theta = torch.where(theta < 0, theta + pi, theta)
    sq1 = torch.sqrt(torch.clamp(l1, min=0.0))
    sq2 = torch.sqrt(torch.clamp(l2, min=0.0))
    den = sq1 + sq2
    coh = torch.where(den != 0, (sq1 - sq2) / torch.where(den == 0, 1.0, den), 0.0)
    na, ns, nc = cfg["num_angle"], cfg["num_strength"], cfg["num_coherence"]
    angle = torch.clamp((theta / pi * na).to(torch.int64), 0, na - 1)
    strength = sum((l1 >= q).to(torch.int64) for q in cfg["strength_quantizers"])
    coherence = sum((coh >= q).to(torch.int64) for q in cfg["coherence_quantizers"])
    return (angle * ns + strength) * nc + coherence


def upsample(lr: torch.Tensor, bank: np.ndarray, cfg: dict,
             stage_dtype: torch.dtype = torch.float32,
             apply_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """RAISR of uint8 [B, H, W] -> uint8 [B, sH, sW] on ``lr``'s device."""
    s, fl = cfg["scale"], cfg["filter_len"]
    m = fl // 2
    up = rounded(cheap_upscale(div(lr.to(torch.float32), 255.0), s), stage_dtype)
    buckets = hash_buckets(up, cfg)
    bsz, hh, ww = up.shape
    ptype = ((torch.arange(hh, device=up.device) % s)[:, None] * s
             + (torch.arange(ww, device=up.device) % s)[None, :])
    fidx = buckets * (s * s) + ptype  # [B, sH, sW]
    taps_of = rounded(torch.from_numpy(bank.reshape(bank.shape[0], fl * fl)).to(up.device),
                      apply_dtype).T.contiguous()  # [fl*fl, filters]
    xp = rounded(F.pad(up[:, None], (m,) * 4, mode="replicate")[:, 0], apply_dtype)
    out = torch.empty((bsz, hh, ww), dtype=torch.uint8, device=up.device)
    for r0 in range(0, hh, APPLY_ROWS):
        r1 = min(r0 + APPLY_ROWS, hh)
        f = fidx[:, r0:r1]
        acc = torch.zeros(f.shape, dtype=torch.float32, device=up.device)
        for i in range(fl):
            for j in range(fl):
                acc = acc + taps_of[i * fl + j][f] * xp[:, r0 + i : r1 + i, j : j + ww]
        out[:, r0:r1] = torch.clamp(torch.round(acc * 255.0), 0, 255).to(torch.uint8)
    return out
