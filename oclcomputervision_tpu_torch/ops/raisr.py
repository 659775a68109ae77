"""RAISR super-resolution inference, plane-native, in PyTorch.

Port of ``oclcomputervision_tpu/ops/raisr.py``'s ``fidelity='full'`` path
(``_raisr_planes_batched``): the cheap bilinear upscale writes s*s parity
planes, the gradient hash and the per-pixel filter select/apply run in plane
space, and the only interleaved array ever built is the uint8 output. The
three stages are hand-written CUDA kernels (``kernels/``); everything around
them is plain PyTorch. ``fidelity='shipped'`` (the reference's observable
behaviour, ``_raisr_2d`` with ``_raisr_post``'s shipped branch) is the
interleaved align-corners bilinear resize of ``ops/interpolation`` and, for
colour, an RGB->YUV->RGB round trip: torch ops, no kernel.

Plane convention (shared with the kernels and with the JAX package):
``planes[a*s + b][hp + i, hp + j] = up_e(s*i + a, s*j + b)``, where up_e is
the edge-replicated align-corners upscale at global coordinates.

The table functions below are numpy copies of the JAX package's; tests
hold them equal.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from oclcomputervision_tpu_torch.kernels import raisr as kraisr
from oclcomputervision_tpu_torch.kernels import upscale as kupscale
from oclcomputervision_tpu_torch.ops.interpolation import _resize_plane
from oclcomputervision_tpu_torch.oracle import raisr as oracle_raisr
from oclcomputervision_tpu_torch.oracle.interpolation import axis_weights
from oclcomputervision_tpu_torch.utils.config import RaisrConfig

TILE_H = 64  # plane rows are padded to a multiple of this
LANE = 128  # plane columns are padded to a multiple of this
HALO_ROWS = 8  # extra plane rows below h2p (>= 2 * plane halo)


# ---------------------------------------------------------------------------
# Tables (numpy copies of the JAX package's table functions).
# ---------------------------------------------------------------------------


def _blur_k1(cfg: RaisrConfig) -> np.ndarray:
    """1D factor of the separable structure-tensor Gaussian window
    (``ops/raisr.py:_blur_k1``)."""
    g = cfg.gauss_len // 2
    w2d = oracle_raisr.gaussian2d((cfg.gauss_len, cfg.gauss_len), cfg.gauss_sigma)
    return w2d[g] / np.sqrt(w2d[g, g])


def plane_halo(fl: int, s: int, gauss_len: int = 9) -> int:
    """Origin-aligned plane halo covering the filter's reach and the hash
    stage's (Sobel 1 + blur gauss_len//2) (``raisr_pallas.plane_halo``)."""
    return max(-(-(fl // 2) // s), -(-(gauss_len // 2) // s) + 1)


def _phase_stencil_taps(n_in: int, s: int, phase: int, org: int, n_out: int):
    """Per-phase 1D upscale as a variable-coefficient shift stencil
    (``ops/raisr.py:_phase_stencil_taps``).

    Plane index j samples full-res q = s*(j - org) + phase. In-range q takes
    axis_weights' f32 taps; out-of-range q extends the coordinate map
    linearly so both taps land in the edge padding.

    Returns (pad_lo, pad_hi, {offset d: weight vector [n_out] f32}), with
    out[j] = sum_d w_d[j] * x[clamp(j + d, 0, n_in - 1)].
    """
    q = s * (np.arange(n_out) - org) + phase
    idx = np.empty((n_out, 2), np.int64)
    wgt = np.empty((n_out, 2), np.float32)
    inr = (q >= 0) & (q <= s * n_in - 1)
    g_idx, g_w = axis_weights(s * n_in, n_in, "bilinear", dtype=np.float32)
    idx[inr] = g_idx[q[inr]]
    wgt[inr] = g_w[q[inr]]
    xq = q[~inr].astype(np.float64) * (n_in - 1) / (s * n_in - 1)
    i0 = np.floor(xq).astype(np.int64)
    idx[~inr, 0] = i0
    idx[~inr, 1] = i0 + 1
    wgt[~inr, 0] = 1.0
    wgt[~inr, 1] = 0.0

    j = np.arange(n_out)
    d_all = idx - j[:, None]
    pad_lo = max(0, -int(d_all.min()))
    pad_hi = max(0, int(d_all.max()) + n_out - n_in)
    offs = {}
    for k in range(2):
        dk = d_all[:, k]
        for d in np.unique(dk):
            v = offs.setdefault(int(d), np.zeros(n_out, np.float32))
            m = dk == d
            v[m] += wgt[m, k]
    return pad_lo, pad_hi, offs


def _tap_tables(fl: int, s: int, py: int, px: int, hp: int):
    """Per-tap (plane index, (row, col) offset) of output phase (py, px)
    (``raisr_pallas._tap_tables``): tap (ti, tj) of plane pixel (y, x)
    reads plane ``tap_plane[q]`` at (y, x) + ``tap_off[q]``, q = ti*fl + tj."""
    m = fl // 2
    tap_plane, tap_off = [], []
    for ti in range(fl):
        for tj in range(fl):
            a, ro = (py - m + ti) % s, (py - m + ti) // s
            b, co = (px - m + tj) % s, (px - m + tj) // s
            tap_plane.append(a * s + b)
            tap_off.append((hp + ro, hp + co))
    return tap_plane, tap_off


@dataclasses.dataclass(frozen=True)
class PlaneGeometry:
    """Stage-interface geometry of ``_raisr_planes_batched``
    (``ops/raisr.py:528-537``): plane size (h2p, w2p) padded to
    (TILE_H, LANE) multiples, upscale planes [hq, wq] with origin (hp, hp)."""

    h2p: int
    w2p: int
    hp: int
    hq: int
    wq: int


def plane_geometry(h: int, w: int, cfg: RaisrConfig) -> PlaneGeometry:
    h2p = -(-h // TILE_H) * TILE_H
    w2p = -(-w // LANE) * LANE
    hp = plane_halo(cfg.filter_len, cfg.scale, cfg.gauss_len)
    if hp < -(-(cfg.gauss_len // 2) // cfg.scale) + 1 or 2 * hp > HALO_ROWS:
        raise ValueError(f"plane halo {hp} does not fit the hash reach / halo rows")
    return PlaneGeometry(h2p, w2p, hp, h2p + HALO_ROWS, w2p + LANE)


# ---------------------------------------------------------------------------
# Pipeline.
# ---------------------------------------------------------------------------


class Stages(NamedTuple):
    """The three stage functions the pipeline runs."""

    upscale: Callable
    hash: Callable
    apply: Callable


# the kernel wrappers (plain versions for CPU tensors, kernels for CUDA ones)
KERNEL_STAGES = Stages(
    kupscale.upscale_planes_kernel,
    kraisr.hash_planes_kernel,
    kraisr.apply_filters_planes_kernel,
)
# the plain PyTorch versions on any device (the kernels' reference on the card)
PLAIN_STAGES = Stages(
    kupscale.upscale_planes, kraisr.hash_planes, kraisr.apply_filters_planes
)


def _ct_blend_weight_planes(up_pl, s: int, hp: int, h2p: int, w2p: int):
    """Census-transform blend weights in plane space
    (``ops/raisr.py:_ct_blend_weight_planes``): up_pl [B, s*s, hq, wq] luma
    planes -> weights [B, s*s, h2p, w2p], w = clip((8 - LCC)/6, 0, 1)."""

    def rd(a, b, dr, dc):
        a2, ro = (a + dr) % s, (a + dr) // s
        b2, co = (b + dc) % s, (b + dc) // s
        return up_pl[:, a2 * s + b2, hp + ro : hp + ro + h2p, hp + co : hp + co + w2p]

    outs = []
    for a in range(s):
        for b in range(s):
            center = rd(a, b, 0, 0)
            bits = [rd(a, b, dr, dc) >= center for dr, dc in oracle_raisr.CT_RING]
            lcc = sum((bits[k] != bits[(k + 1) % 8]).float() for k in range(8))
            outs.append(torch.clamp((8.0 - lcc) / 6.0, 0.0, 1.0))
    return torch.stack(outs, dim=1)


def true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d as a true f32 division: on CUDA, dividing by a Python scalar
    multiplies by its reciprocal instead, which can differ in the last bit."""
    return x / torch.tensor(d, dtype=torch.float32, device=x.device)


def interleave_planes(planes: torch.Tensor, s: int, h: int, w: int) -> torch.Tensor:
    """Parity planes [B, s*s, h2p, w2p] -> the interleaved image [B, h, w]:
    element (i, j) of plane a*s + b is pixel (s*i + a, s*j + b); cropped to
    h <= s*h2p rows and w <= s*w2p columns."""
    bsz, _, h2p, w2p = planes.shape
    return (
        planes.reshape(bsz, s, s, h2p, w2p)
        .permute(0, 3, 1, 4, 2)
        .reshape(bsz, s * h2p, s * w2p)[:, :h, :w]
    )


def _raisr_planes_batched(
    imgs_u8: torch.Tensor,
    filters: torch.Tensor,
    cfg: RaisrConfig,
    nchan: int,
    stages: Stages = KERNEL_STAGES,
) -> torch.Tensor:
    """uint8 [B, H, W(, C)] -> uint8 [B, sH, sW(, C)], plane-native.

    The batch rides every stage; colour channels stack into the batch for
    one upscale and one apply launch and share the luma hash.
    """
    s = cfg.scale
    bsz, h, w = imgs_u8.shape[:3]
    geo = plane_geometry(h, w, cfg)
    h2p, w2p, hp, hq, wq = geo.h2p, geo.w2p, geo.hp, geo.hq, geo.wq

    x01 = true_div(imgs_u8.to(torch.float32), 255.0)
    if nchan == 1:
        chan_planes = [stages.upscale(x01, cfg, hq, wq, hp)]
    else:
        stacked = torch.cat([x01[..., c] for c in range(nchan)], dim=0)
        up_all = stages.upscale(stacked, cfg, hq, wq, hp)
        chan_planes = [up_all[c * bsz : (c + 1) * bsz] for c in range(nchan)]

    # the CSC is linear and pointwise: apply it in plane space
    if nchan == 1:
        yuv_planes = chan_planes
    else:
        csc = oracle_raisr.RGB2YUV
        yuv_planes = [
            sum(float(csc[r, c]) * chan_planes[c] for c in range(3)) for r in range(3)
        ]
        if nchan == 4:
            yuv_planes.append(chan_planes[3])  # alpha passes through

    bucket_pl = stages.hash(yuv_planes[0], cfg, hp, h2p, w2p)

    nc = len(yuv_planes)
    stacked_in = yuv_planes[0] if nc == 1 else torch.cat(yuv_planes, dim=0)
    stacked_out = stages.apply(stacked_in, bucket_pl, filters, cfg)
    filtered = [stacked_out[c * bsz : (c + 1) * bsz] for c in range(nc)]

    if cfg.blend == "ct":
        # luma-derived structure weights fade every filtered channel back to
        # the cheap upscale in unstructured regions
        wgt = _ct_blend_weight_planes(yuv_planes[0], s, hp, h2p, w2p)
        filtered = [
            wgt * f + (1.0 - wgt) * yuv_planes[c][:, :, hp : hp + h2p, hp : hp + w2p]
            for c, f in enumerate(filtered)
        ]

    if nchan == 1:
        out_pl = [filtered[0]]
    else:
        inv = oracle_raisr.YUV2RGB
        out_pl = [
            sum(float(inv[r, c]) * filtered[c] for c in range(3)) for r in range(3)
        ]
        if nchan == 4:
            out_pl.append(filtered[3])

    # torch.round, like jnp.round, rounds half to even
    u8 = [torch.clamp(torch.round(o * 255.0), 0, 255).to(torch.uint8) for o in out_pl]
    # interleave in uint8 (4x less traffic than f32), then crop
    outs = [interleave_planes(o, s, s * h, s * w) for o in u8]
    return outs[0] if nchan == 1 else torch.stack(outs, dim=-1)


def _csc(img: torch.Tensor, mat: np.ndarray) -> torch.Tensor:
    """3x3 colour-space conversion of [..., 3] or [..., 4] channels
    (``ops/raisr.py:_csc``): a BGRA input's alpha passes through."""
    m = torch.from_numpy(np.ascontiguousarray(mat, np.float32)).to(img.device)
    if img.shape[-1] == 4:
        return torch.cat([img[..., :3] @ m, img[..., 3:]], dim=-1)
    return img @ m


def _raisr_shipped(imgs_u8: torch.Tensor, s: int, gray: bool) -> torch.Tensor:
    """fidelity='shipped': uint8 [B, H, W, C] -> uint8 [B, sH, sW, C], the
    cheap align-corners bilinear upscale and, for colour, the YUV round trip
    (the reference kernel's early return, raisr.cl:219-230)."""
    x01 = true_div(imgs_u8.to(torch.float32), 255.0)
    h, w = x01.shape[1:3]
    out = _resize_plane(x01, (h * s, w * s), "bilinear")
    if not gray:
        out = _csc(_csc(out, oracle_raisr.RGB2YUV.T), oracle_raisr.YUV2RGB.T)
    return torch.clamp(torch.round(out * 255.0), 0, 255).to(torch.uint8)


def raisr_upsample(
    img: torch.Tensor, filters: torch.Tensor | None, cfg: RaisrConfig = RaisrConfig()
) -> torch.Tensor:
    """RAISR upsample of uint8 [H, W], [H, W, 3/4] or batched [B, ...].

    Runs on ``img``'s device: the CUDA kernels for a CUDA tensor, their
    plain versions for a CPU tensor. ``filters`` is the
    [num_filters, fl, fl] bank (None: all zeros, as the JAX package);
    ``cfg.fidelity == 'shipped'`` reads no bank and launches no kernel.
    """
    if not isinstance(img, torch.Tensor) or img.dtype != torch.uint8:
        raise TypeError("img must be a uint8 torch.Tensor on the target device")
    if cfg.fidelity not in ("full", "shipped"):
        raise ValueError(f"unknown fidelity {cfg.fidelity!r}")
    gray = img.ndim == 2 or (img.ndim == 3 and img.shape[-1] not in (3, 4))
    single = img.ndim == 2 or (img.ndim == 3 and not gray)
    batch = img[None] if single else img
    if cfg.fidelity == "shipped":
        out = _raisr_shipped(batch[..., None] if gray else batch, cfg.scale, gray)
        out = out[..., 0] if gray else out
        return out[0] if single else out
    fl = cfg.filter_len
    if filters is None:
        filters = torch.zeros((cfg.num_filters, fl, fl), device=img.device)
    filters = filters.to(device=img.device, dtype=torch.float32)
    nchan = 1 if gray else img.shape[-1]
    out = _raisr_planes_batched(batch.contiguous(), filters, cfg, nchan)
    return out[0] if single else out
