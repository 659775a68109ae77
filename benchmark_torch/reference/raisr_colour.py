"""Plain PyTorch colour RAISR of RGB uint8 images with the census-transform
blend: ``fidelity='full'``, ``blend='ct'``.

RAISR as Romano, Isidoro and Milanfar publish it (IEEE TCI 2017,
arXiv:1606.01299: the hash, the filter bank and the census-transform blend
of §V), in colour as the upstream kernel runs it
(github.com/saturdaycoder/oclComputerVision ``super_resolution/raisr.cl``
198-217: the cheap upscale, then RGB -> YUV; 322-337: the filter on the YUV
patch, then YUV -> RGB; the matrices of ``raisr.py`` 20-37), written from
the equations in the image domain and independent of the program under
test. Per image of uint8 [B, H, W, 3]:

1. x = rgb / 255 in float32, a true division;
2. the align-corners bilinear cheap upscale of each channel to s H x s W,
   edge-replicated: rows, then columns, each w0 x[i0] + w1 x[i1], with the
   source coordinate o / (n_out - 1) x (n_in - 1) of upstream's
   ``interpolation.cl`` (:58, :92), its fraction u and the weights 1 - u
   and u all in float32;
3. YUV = ``RGB2YUV`` x RGB per pixel, each row's three products summed left
   to right in float32;
4. the hash of Y (``reference/raisr.hash_buckets``) and the filter index
   bucket * s * s + pixel type;
5. the selected filter applied to Y, U and V alike over each edge-padded
   channel, taps and bank rounded to ``apply_dtype`` (bfloat16 as stated:
   the products exact in float32) and summed in float32 in row-major tap
   order;
6. the census weights from Y's cheap upscale: the bits neighbour >= centre
   over the 8-ring in ``CT_RING`` order (edge-replicated), LCC the number
   of bit changes around the ring, w = clip((8 - LCC) / 6, 0, 1) with a
   correctly rounded division;
7. the blend w f + (1 - w) cheap of each channel;
8. RGB = ``YUV2RGB`` x YUV, rows summed left to right in float32;
9. round half to even of 255 x, clamped to [0, 255], cast to uint8.

Departures from the paper, as the configuration's ``assumed`` states them:
the paper filters luma alone and upscales chroma bicubically, while this
system (as upstream) filters Y, U and V with the luma's filter; the colour
space is upstream's BT.601 analog YUV (U and V unscaled, no offset); the
cheap upscale is upstream's align-corners bilinear; the blend's weight is
the LCC ramp clip((8 - LCC) / 6, 0, 1), taken on the cheap upscale's luma,
and it blends U and V with Y's weight.

``stage_dtype`` rounds the upscale, both colour conversions and the census
weights to a lower precision where the control asks for it; float32
leaves them as stated.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark_torch.reference.raisr import APPLY_ROWS, div, hash_buckets, rounded

# upstream super_resolution/raisr.py:20-37 (BT.601 analog YUV)
RGB2YUV = ((0.299, 0.587, 0.114),
           (-0.14713, -0.28886, 0.436),
           (0.615, -0.51499, -0.10001))
YUV2RGB = ((1.0, 0.0, 1.13983),
           (1.0, -0.39465, -0.58060),
           (1.0, 2.03211, 0.0))
# the census ring, clockwise from the upper-left neighbour: (row, column) offsets
CT_RING = ((-1, -1), (-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1), (0, -1))


def axis_taps(n_out: int, n_in: int, device):
    """Align-corners bilinear taps of one axis in float32: indices i0, i1
    [n_out] (i1 clamped to the edge) and weights w0 = 1 - u, w1 = u of the
    source coordinate x = o / (n_out - 1) * (n_in - 1), u = x - floor x."""
    o = np.arange(n_out, dtype=np.float32)
    if n_out > 1:
        x = o / np.float32(n_out - 1) * np.float32(n_in - 1)
    else:
        x = np.zeros(1, np.float32)
    x0 = np.floor(x)
    u = (x - x0).astype(np.float32)
    i0 = x0.astype(np.int64)
    i1 = np.minimum(i0 + 1, n_in - 1)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return t(i0), t(i1), t((np.float32(1.0) - u).astype(np.float32)), t(u)


def cheap_upscale(x01: torch.Tensor, s: int) -> torch.Tensor:
    """[B, H, W] float32 -> the align-corners bilinear [B, sH, sW]: rows,
    then columns, each w0 x[i0] + w1 x[i1]."""
    _, h, w = x01.shape
    r0, r1, rw0, rw1 = axis_taps(s * h, h, x01.device)
    c0, c1, cw0, cw1 = axis_taps(s * w, w, x01.device)
    rows = rw0[None, :, None] * x01[:, r0] + rw1[None, :, None] * x01[:, r1]
    return cw0 * rows[:, :, c0] + cw1 * rows[:, :, c1]


def csc(chans: list, mat, stage_dtype: torch.dtype = torch.float32) -> list:
    """[c0, c1, c2] float32 -> the three rows of ``mat`` applied per pixel,
    each the float32 products of the float32 coefficients summed left to
    right."""
    out = []
    for row in mat:
        acc = None
        for m, ch in zip(row, chans):
            term = float(np.float32(m)) * ch
            acc = term if acc is None else acc + term
        out.append(rounded(acc, stage_dtype))
    return out


def ct_weights(y: torch.Tensor, stage_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The census blend weight of every pixel of [B, H, W] ``y``."""
    h, w = y.shape[1:]
    yp = F.pad(y[:, None], (1,) * 4, mode="replicate")[:, 0]
    bits = [yp[:, 1 + dr : 1 + dr + h, 1 + dc : 1 + dc + w] >= y for dr, dc in CT_RING]
    lcc = sum((bits[k] != bits[(k + 1) % 8]).to(torch.float32) for k in range(8))
    return rounded(torch.clamp(div(8.0 - lcc, 6.0), 0.0, 1.0), stage_dtype)


def apply_filters(chans: list, fidx: torch.Tensor, bank: np.ndarray, fl: int,
                  apply_dtype: torch.dtype) -> list:
    """Each [B, H, W] channel filtered by the per-pixel filter ``fidx``: the
    fl x fl taps over the edge-padded channel, taps and bank rounded to
    ``apply_dtype``, the products summed in float32 in row-major order. In
    blocks of rows, the filter's weights gathered once for every channel."""
    m = fl // 2
    dev = fidx.device
    taps_of = rounded(torch.from_numpy(bank.reshape(bank.shape[0], fl * fl)).to(dev),
                      apply_dtype).T.contiguous()  # [fl*fl, filters]
    xps = [rounded(F.pad(c[:, None], (m,) * 4, mode="replicate")[:, 0], apply_dtype)
           for c in chans]
    outs = [torch.empty_like(c) for c in chans]
    hh, ww = fidx.shape[1:]
    for r0 in range(0, hh, APPLY_ROWS):
        r1 = min(r0 + APPLY_ROWS, hh)
        f = fidx[:, r0:r1]
        accs = [torch.zeros(f.shape, dtype=torch.float32, device=dev) for _ in chans]
        for i in range(fl):
            for j in range(fl):
                tap = taps_of[i * fl + j][f]
                for k, xp in enumerate(xps):
                    accs[k] = accs[k] + tap * xp[:, r0 + i : r1 + i, j : j + ww]
        for out, acc in zip(outs, accs):
            out[:, r0:r1] = acc
    return outs


def upsample(rgb: torch.Tensor, bank: np.ndarray, cfg: dict,
             stage_dtype: torch.dtype = torch.float32,
             apply_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Colour RAISR with the census blend of uint8 [B, H, W, 3] -> uint8
    [B, sH, sW, 3] on ``rgb``'s device."""
    s, fl = cfg["scale"], cfg["filter_len"]
    x01 = div(rgb.to(torch.float32), 255.0)
    cheap = csc([rounded(cheap_upscale(x01[..., c].contiguous(), s), stage_dtype)
                 for c in range(3)], RGB2YUV, stage_dtype)
    y = cheap[0]
    bsz, hh, ww = y.shape
    ptype = ((torch.arange(hh, device=y.device) % s)[:, None] * s
             + (torch.arange(ww, device=y.device) % s)[None, :])
    fidx = hash_buckets(y, cfg) * (s * s) + ptype  # [B, sH, sW]
    filtered = apply_filters(cheap, fidx, bank, fl, apply_dtype)
    wgt = ct_weights(y, stage_dtype)
    blended = [wgt * f + (1.0 - wgt) * c for f, c in zip(filtered, cheap)]
    out = csc(blended, YUV2RGB, stage_dtype)
    return torch.stack([torch.clamp(torch.round(o * 255.0), 0, 255).to(torch.uint8)
                        for o in out], dim=-1)
