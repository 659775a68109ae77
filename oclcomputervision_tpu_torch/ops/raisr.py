"""RAISR super-resolution inference, plane-native, in PyTorch.

Port of ``oclcomputervision_tpu/ops/raisr.py``'s ``fidelity='full'`` path
(``_raisr_planes_batched``): the cheap bilinear upscale writes s*s parity
planes, the gradient hash and the per-pixel filter select/apply run in plane
space, and the only interleaved array ever built is the uint8 output. The
three stages are hand-written CUDA kernels (``kernels/``); everything around
them is plain PyTorch. ``fidelity='shipped'`` (the reference's observable
behaviour, ``_raisr_2d`` with ``_raisr_post``'s shipped branch) is the
interleaved align-corners bilinear resize of ``ops/interpolation`` and, for
colour, an RGB->YUV->RGB round trip: torch ops, no kernel. Under a
profiler the call is the span ``ocv.raisr`` of ``utils.tracing``, with the
full path's stages ``ocv.raisr.in``, ``.upscale``, ``.hash``, ``.apply``
and ``.out`` inside it.

Plane convention (shared with the kernels and with the JAX package):
``planes[a*s + b][hp + i, hp + j] = up_e(s*i + a, s*j + b)``, where up_e is
the edge-replicated align-corners upscale at global coordinates.

The table functions below are numpy copies of the JAX package's; tests
hold them equal. The last section has the JAX module's public image-domain
and plane functions (``hash_components``, ``hash_image``,
``pixel_type_map``, ``apply_filters``, ``apply_filters_fast``,
``ct_blend_weights``, ``upscale_planes``, ``hash_planes``), which no path
of the port calls.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from oclcomputervision_tpu_torch._device import as_device
from oclcomputervision_tpu_torch.kernels import raisr as kraisr
from oclcomputervision_tpu_torch.kernels import upscale as kupscale
from oclcomputervision_tpu_torch.ops.interpolation import _axis_table, _resize_plane
from oclcomputervision_tpu_torch.oracle import raisr as oracle_raisr
from oclcomputervision_tpu_torch.oracle.interpolation import axis_weights
from oclcomputervision_tpu_torch.utils import tracing
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
    row0: int = 0,
    h_img: int | None = None,
) -> torch.Tensor:
    """uint8 [B, H, W(, C)] -> uint8 [B, sH, sW(, C)], plane-native.

    The batch rides every stage; colour channels stack into the batch for
    one upscale and one apply launch and share the luma hash. ``row0`` and
    ``h_img``: the images are row bands from LR row ``row0`` of
    ``h_img``-row images, upscaled at the whole images' coordinates.
    """
    s = cfg.scale
    bsz, h, w = imgs_u8.shape[:3]
    geo = plane_geometry(h, w, cfg)
    h2p, w2p, hp, hq, wq = geo.h2p, geo.w2p, geo.hp, geo.hq, geo.wq

    with tracing.span("ocv.raisr.in"):
        x01 = true_div(imgs_u8.to(torch.float32), 255.0)
    with tracing.span("ocv.raisr.upscale"):
        if nchan == 1:
            chan_planes = [stages.upscale(x01, cfg, hq, wq, hp, row0, h_img)]
        else:
            stacked = torch.cat([x01[..., c] for c in range(nchan)], dim=0)
            up_all = stages.upscale(stacked, cfg, hq, wq, hp, row0, h_img)
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

    with tracing.span("ocv.raisr.hash"):
        bucket_pl = stages.hash(yuv_planes[0], cfg, hp, h2p, w2p)

    nc = len(yuv_planes)
    with tracing.span("ocv.raisr.apply"):
        stacked_in = yuv_planes[0] if nc == 1 else torch.cat(yuv_planes, dim=0)
        stacked_out = stages.apply(stacked_in, bucket_pl, filters, cfg)
        filtered = [stacked_out[c * bsz : (c + 1) * bsz] for c in range(nc)]

    with tracing.span("ocv.raisr.out"):
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


def min_band_halo(cfg: RaisrConfig) -> int:
    """The fewest LR rows a row band must carry beyond the rows it keeps
    (``parallel/mesh.py:404`` of the JAX package): the HR receptive field
    after the upscale (Sobel 1 + gauss_len // 2 blur + filter_len // 2
    filter rows) in LR rows, plus one for the bilinear support."""
    return -(-(cfg.gauss_len // 2 + 1 + cfg.filter_len // 2) // cfg.scale) + 1


def _raisr_band(
    lr_band: torch.Tensor,
    row0: int,
    h_img: int,
    filters: torch.Tensor,
    cfg: RaisrConfig,
) -> torch.Tensor:
    """RAISR of a row band: uint8 [h, W] holding LR rows [row0, row0 + h)
    of an ``h_img``-row gray image -> uint8 [s*h, s*W].

    The upscale samples the band at the image's align-corners coordinates
    (``kernels.upscale.band_row_table``), so its planes are rows of the
    image's planes; the hash and the apply then run on them as on any
    image. HR rows farther than ``s * min_band_halo(cfg)`` from a band edge
    that is not the image's equal the whole image's output. Band rows
    outside the image (row0 < 0, row0 + h > h_img) are never read: the
    image's stencil clamps to its own edge rows.
    """
    return _raisr_planes_batched(
        lr_band[None].contiguous(), filters, cfg, 1, KERNEL_STAGES, row0, h_img
    )[0]


def _csc(img: torch.Tensor, mat: np.ndarray) -> torch.Tensor:
    """3x3 colour-space conversion of [..., 3] or [..., 4] channels
    (``ops/raisr.py:_csc``): a BGRA input's alpha passes through."""
    m = torch.from_numpy(np.ascontiguousarray(mat, np.float32)).to(img.device)
    if img.shape[-1] == 4:
        return torch.cat([img[..., :3] @ m, img[..., 3:]], dim=-1)
    return img @ m


def _raisr_shipped(
    imgs_u8: torch.Tensor, s: int, gray: bool, row0: int = 0, h_img: int | None = None
) -> torch.Tensor:
    """fidelity='shipped': uint8 [B, H, W, C] -> uint8 [B, sH, sW, C], the
    cheap align-corners bilinear upscale and, for colour, the YUV round trip
    (the reference kernel's early return, raisr.cl:219-230).

    ``row0`` and ``h_img``: the images are row bands from LR row ``row0`` of
    ``h_img``-row images (the row-sharded RAISR). HR row q of the band is the
    image's HR row s * row0 + q, clamped to the image, with the image's taps
    rebased into the band and clamped to it: the rows whose taps lie in the
    band equal the whole image's output bit for bit."""
    x01 = true_div(imgs_u8.to(torch.float32), 255.0)
    h, w = x01.shape[1:3]
    rows = None
    if h_img is not None:
        yidx, yw = _axis_table(h_img * s, h_img, "bilinear", "align_corners", x01.device)
        q = torch.clamp(s * row0 + torch.arange(h * s, device=x01.device), 0, h_img * s - 1)
        rows = (torch.clamp(yidx[:, q] - row0, 0, h - 1), yw[:, q])
    out = _resize_plane(x01, (h * s, w * s), "bilinear", rows=rows)
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
    with tracing.span("ocv.raisr"):
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


# ---------------------------------------------------------------------------
# Image-domain and plane ops (the JAX package's ``ops/raisr.py`` public
# functions). No path of the port calls them; JAX computes them with XLA.
# Interleaved ones are f32 torch ops on the input's device; the two plane
# ops go through the kernel wrappers (the CUDA kernel for a CUDA tensor, its
# plain version for a CPU one).
# ---------------------------------------------------------------------------


def _edge_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Edge-replicate the last two dims of [..., H, W] by ``pad``."""
    h, w = x.shape[-2:]
    xp = torch.nn.functional.pad(x.reshape(-1, 1, h, w), (pad,) * 4, mode="replicate")
    return xp.reshape(*x.shape[:-2], h + 2 * pad, w + 2 * pad)


def _correlate2d_valid(img: torch.Tensor, kern: np.ndarray) -> torch.Tensor:
    """'valid' correlation of [..., H, W] with a small constant kernel, as
    the JAX package's k*k shifted multiply-adds in the same order."""
    kh, kw = kern.shape
    h = img.shape[-2] - kh + 1
    w = img.shape[-1] - kw + 1
    out = torch.zeros(img.shape[:-2] + (h, w), dtype=img.dtype, device=img.device)
    for i in range(kh):
        for j in range(kw):
            if kern[i, j] != 0.0:
                out = out + float(kern[i, j]) * img[..., i : i + h, j : j + w]
    return out


def _gauss_blur_valid(img: torch.Tensor, k1d: np.ndarray) -> torch.Tensor:
    """Separable 'valid' blur of [..., H, W] with a 1D kernel, rows first."""
    k = k1d.shape[0]
    h = img.shape[-2] - k + 1
    out = torch.zeros(img.shape[:-2] + (h, img.shape[-1]), dtype=img.dtype, device=img.device)
    for i in range(k):
        out = out + float(np.float32(k1d[i])) * img[..., i : i + h, :]
    w = img.shape[-1] - k + 1
    out2 = torch.zeros(img.shape[:-2] + (h, w), dtype=img.dtype, device=img.device)
    for j in range(k):
        out2 = out2 + float(np.float32(k1d[j])) * out[..., j : j + w]
    return out2


def hash_components(up_y: torch.Tensor, cfg: RaisrConfig):
    """Per-pixel (angle_idx, strength_idx, coherence_idx), each [H, W] int32,
    of the cheap-upscaled luma [H, W]: Sobel gradients of the edge-padded
    image, the separable gauss_len^2 structure-tensor blur, eigen analysis."""
    pad = cfg.gauss_len // 2 + 1
    y = _edge_pad(up_y.to(torch.float32), pad)
    gx = _correlate2d_valid(y, oracle_raisr.SOBEL_X)
    gy = _correlate2d_valid(y, oracle_raisr.SOBEL_Y)
    k1 = _blur_k1(cfg)
    a = _gauss_blur_valid(gx * gx, k1)
    b = _gauss_blur_valid(gx * gy, k1)
    d = _gauss_blur_valid(gy * gy, k1)
    return kraisr._eigen_bucket(a, b, d, cfg)


def hash_image(up_y: torch.Tensor, cfg: RaisrConfig) -> torch.Tensor:
    """Per-pixel (angle, strength, coherence) bucket [H, W] int32."""
    ai, si, ci = hash_components(up_y, cfg)
    return ((ai * cfg.num_strength + si) * cfg.num_coherence + ci).to(torch.int32)


def pixel_type_map(h: int, w: int, scale: int, *, device=None) -> torch.Tensor:
    """[h, w] int32 pixel type (y % scale) * scale + (x % scale), on
    ``device`` (None: the card)."""
    dev = as_device(device)
    yy = torch.arange(h, dtype=torch.int32, device=dev)[:, None]
    xx = torch.arange(w, dtype=torch.int32, device=dev)[None, :]
    return (yy % scale) * scale + (xx % scale)


def apply_filters(
    up: torch.Tensor, fidx: torch.Tensor, filters: torch.Tensor, cfg: RaisrConfig
) -> torch.Tensor:
    """out[p] = sum_q filters[fidx[p], q] * up[p + q - m] of [H, W] or
    [H, W, C] f32 ``up`` (edge-padded; every channel takes the pixel's
    filter), ``fidx`` [H, W] the filter index, ``filters`` [num_filters,
    fl, fl]: the taps added in row-major order, in f32."""
    fl = cfg.filter_len
    m = fl // 2
    squeeze = up.ndim == 2
    x = (up[..., None] if squeeze else up).to(torch.float32)
    h, w = x.shape[:2]
    xp = _edge_pad(x.permute(2, 0, 1), m).permute(1, 2, 0)
    bank = filters.to(device=x.device, dtype=torch.float32).reshape(-1, fl * fl)
    sel = bank[fidx.reshape(-1).to(torch.int64)].reshape(h, w, fl * fl)
    out = torch.zeros_like(x)
    for i in range(fl):
        for j in range(fl):
            out = out + sel[:, :, i * fl + j, None] * xp[i : i + h, j : j + w]
    return out[..., 0] if squeeze else out


def apply_filters_fast(
    up: torch.Tensor,
    angle_idx: torch.Tensor,
    strength_idx: torch.Tensor,
    coherence_idx: torch.Tensor,
    filters: torch.Tensor,
    cfg: RaisrConfig,
) -> torch.Tensor:
    """``apply_filters`` split over the s x s pixel-type phases, in f32 (the
    JAX package's XLA twin): phase (py, px) takes the stride-s im2col of the
    edge-padded image from (py, px) and, per pixel, the row of its
    (angle, strength, coherence) bucket in the phase's slice of the bank.
    [H, W] or [H, W, C] with H and W multiples of the scale."""
    s = cfg.scale
    fl = cfg.filter_len
    m = fl // 2
    nb = cfg.num_angle * cfg.num_strength * cfg.num_coherence
    squeeze = up.ndim == 2
    x = (up[..., None] if squeeze else up).to(torch.float32)
    h, w, c = x.shape
    if h % s or w % s:
        raise ValueError(f"apply_filters_fast takes H and W multiples of the scale {s}, "
                         f"got {h} x {w}")
    h2, w2 = h // s, w // s
    xp = _edge_pad(x.permute(2, 0, 1), m)  # [C, H + 2m, W + 2m]
    bank = filters.to(device=x.device, dtype=torch.float32).reshape(
        nb, cfg.num_pixel_type, fl * fl)
    bucket = (angle_idx.to(torch.int64) * cfg.num_strength + strength_idx) * cfg.num_coherence
    bucket = bucket + coherence_idx
    out = torch.empty((c, h, w), dtype=torch.float32, device=x.device)
    for py in range(s):
        for px in range(s):
            # [C, fl*fl, h2*w2]: the patch of each phase pixel, taps row-major
            win = xp[:, None, py : py + (h2 - 1) * s + fl, px : px + (w2 - 1) * s + fl]
            patches = torch.nn.functional.unfold(win, (fl, fl), stride=s)
            rows = bank[bucket[py::s, px::s].reshape(-1), py * s + px]  # [h2*w2, fl*fl]
            out[:, py::s, px::s] = (patches * rows.T[None]).sum(1).reshape(c, h2, w2)
    out = out.permute(1, 2, 0)
    return out[..., 0] if squeeze else out


def upscale_planes(
    x01: torch.Tensor, cfg: RaisrConfig, h2p: int, w2p: int, hq: int, wq: int, hp: int
) -> torch.Tensor:
    """Cheap-upscale a [..., h, w] float image straight into parity planes
    [..., s*s, hq, wq] f32 with origin (hp, hp), edge-replicated outside the
    image (the JAX signature; ``h2p`` and ``w2p`` are not read there either).
    Leading dims are a batch; through ``kernels.upscale.upscale_planes_kernel``,
    whose CUDA form takes plane widths that are multiples of 4: the planes
    are computed that wide and cropped (a column's value does not depend on
    the width)."""
    s = cfg.scale
    h, w = x01.shape[-2:]
    lead = x01.shape[:-2]
    x = x01.to(torch.float32).reshape(-1, h, w).contiguous()
    wq4 = -(-wq // 4) * 4
    planes = kupscale.upscale_planes_kernel(x, cfg, hq, wq4, hp)[..., :wq]
    return planes.reshape(*lead, s * s, hq, wq)


def hash_planes(
    y_planes: torch.Tensor, cfg: RaisrConfig, hp: int, h2p: int, w2p: int
) -> torch.Tensor:
    """Per-pixel hash bucket in plane space: luma planes [..., s*s, rows,
    cols] (origin (hp, hp), rows >= h2p + 2 hp, cols >= w2p + 2 hp) ->
    bucket planes [..., s*s, h2p, w2p] int32; leading dims are a batch.
    Through ``kernels.raisr.hash_planes_kernel``."""
    lead = y_planes.shape[:-3]
    ss, rows, cols = y_planes.shape[-3:]
    y = y_planes.to(torch.float32).reshape(-1, ss, rows, cols).contiguous()
    return kraisr.hash_planes_kernel(y, cfg, hp, h2p, w2p).reshape(*lead, ss, h2p, w2p)


def ct_blend_weights(up_y: torch.Tensor) -> torch.Tensor:
    """Census-transform structure weights [..., H, W] in [0, 1] of the
    cheap-upscaled luma (RAISR paper §V): w = clip((8 - LCC) / 6, 0, 1) from
    the 3x3 census ring, edge-replicated borders."""
    h, w = up_y.shape[-2:]
    xp = _edge_pad(up_y, 1)
    bits = [xp[..., 1 + dr : 1 + dr + h, 1 + dc : 1 + dc + w] >= up_y
            for dr, dc in oracle_raisr.CT_RING]
    lcc = sum((bits[k] != bits[(k + 1) % 8]).to(torch.float32) for k in range(8))
    return torch.clamp(true_div(8.0 - lcc, 6.0), 0.0, 1.0)
