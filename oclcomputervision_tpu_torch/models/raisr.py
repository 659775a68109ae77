"""RAISR model: the learned filter bank as an ``nn.Module``, and its trainer.

Port of ``oclcomputervision_tpu/models/raisr.py``: ``load`` and ``save`` read
and write the same ``.npz`` banks, ``upsample`` runs
``ops.raisr.raisr_upsample`` on the model's device, ``from_numpy`` carries a
JAX model's bank and config across (``np.asarray(jax_model.filters)``,
``jax_model.cfg``), and ``train`` / ``train_filters`` solve a bank from HR
images (RAISR paper, arXiv:1606.01299 §III): for each hash bucket b, ridge
least squares

    filters[b] = argmin_f sum_{p: hash(p)=b} (patch(p) . f - hr(p))^2

where patch(p) is the fl x fl cheap-upscaled-luma patch around HR pixel p.

The feature stage runs the inference path's stages (``ops.raisr.KERNEL_STAGES``:
the upscale and hash kernels on a CUDA tensor, their plain versions on a CPU
one), so train and apply see identical features. The normal equations are
accumulated per bucket with ``torch.matmul`` over the pixels sorted by
bucket: deterministic on the card (no atomics), and a bucket's Gram instead
of the JAX package's one-hot einsum over every bucket. The solve is
``torch.linalg.solve`` in f32. Everything runs on the card unless
``device="cpu"`` is passed.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from oclcomputervision_tpu_torch._device import as_device
from oclcomputervision_tpu_torch.ops.raisr import (
    KERNEL_STAGES,
    Stages,
    interleave_planes,
    plane_geometry,
    raisr_upsample,
    true_div,
)
from oclcomputervision_tpu_torch.oracle import raisr as oracle_raisr
from oclcomputervision_tpu_torch.utils.config import RaisrConfig


def port_config(cfg) -> RaisrConfig:
    """The port's ``RaisrConfig`` with the fields of ``cfg``, which may be a
    config of another package (the JAX package's ``RaisrConfig``)."""
    return RaisrConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(RaisrConfig)})


def extract_patches(img: torch.Tensor, fl: int) -> torch.Tensor:
    """All fl x fl patches (edge-padded) of [H, W] -> [H*W, fl*fl], tap
    i*fl + j at row offset i, column offset j."""
    m = fl // 2
    xp = F.pad(img[None, None], (m, m, m, m), mode="replicate")
    return F.unfold(xp, fl)[0].T.contiguous()


def _training_arrays(hr_y01: torch.Tensor, cfg: RaisrConfig, stages: Stages = KERNEL_STAGES):
    """From one HR luma image [H, W] f32: (patches [N, fl*fl], targets [N],
    fidx [N]), N = H*W after cropping to multiples of the scale.

    LR is the s x s box mean of HR (the standard RAISR degradation). The
    cheap upscale and the hash are the inference path's ``stages`` at
    ``plane_geometry``; their planes are interleaved and cropped to the HR
    image, and the patches are taken from the edge-padded interleaved upscale.
    """
    s = cfg.scale
    h, w = hr_y01.shape
    h -= h % s
    w -= w % s
    hr = hr_y01[:h, :w]
    lr = true_div(hr.reshape(h // s, s, w // s, s).sum(dim=(1, 3)), float(s * s))
    geo = plane_geometry(h // s, w // s, cfg)
    up_pl = stages.upscale(lr[None].contiguous(), cfg, geo.hq, geo.wq, geo.hp)
    bucket_pl = stages.hash(up_pl, cfg, geo.hp, geo.h2p, geo.w2p)
    interior = up_pl[:, :, geo.hp : geo.hp + geo.h2p, geo.hp : geo.hp + geo.w2p]
    up = interleave_planes(interior, s, h, w)[0]
    # plane a*s + b holds the pixels of type a*s + b
    ptype = torch.arange(s * s, dtype=torch.int32, device=hr.device)[:, None, None]
    fidx_pl = bucket_pl * cfg.num_pixel_type + ptype
    fidx = interleave_planes(fidx_pl, s, h, w)[0]
    patches = extract_patches(up, cfg.filter_len)
    return patches, hr.reshape(-1), fidx.reshape(-1)


def accumulate_normal_eq(patches, targets, fidx, num_filters: int, chunk: int = 1024):
    """Per-bucket normal equations: G [NF, d, d], r [NF, d], counts [NF] f32.

    The pixels are sorted by bucket (stably), and each bucket's
    ``P_b^T P_b`` and ``P_b^T y_b`` come from one ``torch.matmul`` of
    ``[P_b | y_b]`` with itself per piece of at most ``chunk`` of its pixels,
    the pieces summed in order. No atomics: the same inputs give the same
    bits on every run.
    """
    n, d = patches.shape
    fidx = fidx.to(torch.int64)
    cnt = torch.bincount(fidx, minlength=num_filters)
    if cnt.shape[0] != num_filters:
        raise ValueError(f"filter index {int(fidx.max())} >= {num_filters} filters")
    order = torch.sort(fidx, stable=True).indices
    q = torch.cat([patches, targets[:, None]], dim=1)[order]
    gr = torch.zeros((num_filters, d + 1, d + 1), dtype=torch.float32, device=patches.device)
    start = 0
    for b, nb in enumerate(cnt.tolist()):
        for p0 in range(start, start + nb, chunk):
            qb = q[p0 : min(p0 + chunk, start + nb)]
            gr[b] += qb.T @ qb
        start += nb
    return gr[:, :d, :d].contiguous(), gr[:, :d, d].contiguous(), cnt.to(torch.float32)


def solve_filters(g, r, cnt, filter_len: int, ridge: float = 0.03):
    """Per-bucket delta-biased ridge solve, batched through
    ``torch.linalg.solve`` in f32.

    The raw normal equations are badly conditioned (image patches are
    highly correlated; cond(G) ~ 1e7) and buckets can have fewer samples
    than the filter taps, so unregularized solves yield huge
    coefficients that amplify quantization noise at inference. The ridge
    is scaled per bucket by the mean Gram diagonal and strengthened for
    sample-starved buckets, biasing toward the identity (delta) filter -
    empty buckets degrade exactly to the cheap upscale.
    """
    d = filter_len * filter_len
    dev = g.device
    delta = torch.zeros((d,), dtype=torch.float32, device=dev)
    delta[d // 2] = 1.0
    diag_mean = true_div(torch.diagonal(g, dim1=1, dim2=2).sum(-1), float(d))
    starve = 1.0 + torch.tensor(float(d), dtype=torch.float32, device=dev) / (cnt + 1.0)
    lam = (ridge * diag_mean * starve + 1e-8)[:, None]
    gi = g + lam[..., None] * torch.eye(d, dtype=torch.float32, device=dev)[None]
    ri = r + lam * delta[None, :]
    f = torch.linalg.solve(gi, ri[..., None])[..., 0]
    return f.reshape(-1, filter_len, filter_len)


def hr_luma01(img: np.ndarray) -> np.ndarray:
    """The luma in [0, 1] of a uint8 gray or RGB image, in float64 on the
    host, as the JAX package forms it."""
    img = np.asarray(img)
    x01 = img.astype(np.float64) / 255.0
    return x01 @ oracle_raisr.RGB2YUV[0] if img.ndim == 3 else x01


def dihedral_transforms(img: np.ndarray):
    """The 8 symmetries of the square: 4 rotations x optional mirror."""
    out = []
    for k in range(4):
        r = np.rot90(img, k)
        out.append(r)
        out.append(np.fliplr(r))
    return out


# Per-scale ridge tuned on a VALIDATION split only (right 40% of
# under_exposure, never trained on; frame11 - the reported frame - is
# untouched by training AND tuning; see examples/train_banks.py for the
# full protocol). The optimum is sharp at small ridge (0.002 collapses
# by 2 dB - ill-conditioned buckets), flat above.
RIDGE_BY_SCALE = {2: 0.004, 3: 0.01, 4: 0.01}


def train_filters(
    hr_images: Sequence[np.ndarray],
    cfg: RaisrConfig = RaisrConfig(),
    ridge: float | None = None,
    chunk: int = 1024,
    augment: bool = False,
    *,
    device=None,
) -> torch.Tensor:
    """Train the filter bank from uint8 HR images (gray or RGB) on ``device``
    (None: the card).

    ``ridge=None`` selects the held-out-tuned per-scale default
    (RIDGE_BY_SCALE, 0.03 for unlisted scales).

    ``augment`` accumulates every image under all 8 dihedral transforms
    (RAISR paper §IV "8x augmentation"): rotated/mirrored edges fill the
    angle buckets a small corpus would leave starved. Each transformed
    image is re-hashed, which is exact even where the hash is not
    perfectly equivariant (quantizer edges, image borders).

    ``augment=True`` uses the augmented statistics everywhere;
    ``augment="starved"`` keeps the NATIVE-orientation filters for
    buckets with enough samples (>= 2 taps^2) and uses the symmetrized
    ones only where the native solve is sample-starved.

    Returns filters [num_filters, fl, fl] float32 on ``device``.
    """
    dev = as_device(device)
    if ridge is None:
        ridge = RIDGE_BY_SCALE.get(cfg.scale, 0.03)
    starved = augment == "starved"
    d = cfg.filter_len * cfg.filter_len

    def zeros():
        return (
            torch.zeros((cfg.num_filters, d, d), dtype=torch.float32, device=dev),
            torch.zeros((cfg.num_filters, d), dtype=torch.float32, device=dev),
            torch.zeros((cfg.num_filters,), dtype=torch.float32, device=dev),
        )

    g, r, cnt = zeros()  # every variant's sums
    if starved:
        g_nat, r_nat, cnt_nat = zeros()  # the identity transform's alone
    for img in hr_images:
        img = img.cpu().numpy() if isinstance(img, torch.Tensor) else img
        y01 = hr_luma01(img)
        variants = dihedral_transforms(y01) if augment else [y01]
        for k, v in enumerate(variants):
            hr = torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(dev)
            dg, dr, dc = accumulate_normal_eq(*_training_arrays(hr, cfg), cfg.num_filters, chunk)
            g, r, cnt = g + dg, r + dr, cnt + dc
            if starved and k == 0:
                g_nat, r_nat, cnt_nat = g_nat + dg, r_nat + dr, cnt_nat + dc
    f_all = solve_filters(g, r, cnt, cfg.filter_len, ridge)
    if not starved:
        return f_all
    f_nat = solve_filters(g_nat, r_nat, cnt_nat, cfg.filter_len, ridge)
    return torch.where((cnt_nat < 2.0 * d)[:, None, None], f_all, f_nat)


class RaisrModel(nn.Module):
    """Filter bank [num_filters, fl, fl] f32 (a buffer; None until trained
    or loaded) plus its config."""

    def __init__(self, cfg: RaisrConfig = RaisrConfig(), filters: torch.Tensor | None = None):
        super().__init__()
        fl = cfg.filter_len
        if filters is not None:
            if tuple(filters.shape) != (cfg.num_filters, fl, fl):
                raise ValueError(
                    f"bank shape {tuple(filters.shape)} != {(cfg.num_filters, fl, fl)}"
                )
            filters = filters.to(torch.float32)
        self.cfg = cfg
        self.register_buffer("filters", filters)

    @classmethod
    def from_numpy(cls, filters, cfg, device=None) -> "RaisrModel":
        """Bank from a numpy array (for example a JAX model's filters); ``cfg``
        is carried across by its fields."""
        cfg = port_config(cfg)
        fl = cfg.filter_len
        bank = np.asarray(filters, np.float32).reshape(cfg.num_filters, fl, fl)
        return cls(cfg, torch.from_numpy(bank.copy()).to(as_device(device)))

    @classmethod
    def load(
        cls, path: str, fidelity: str = "full", blend: str = "none", *, device=None
    ) -> "RaisrModel":
        """Load a bank saved by either package's ``RaisrModel.save``."""
        with np.load(path) as z:
            na, ns, nc, fl, sc = (int(v) for v in z["cfg"])
            filters = z["filters"]
        cfg = RaisrConfig(
            num_angle=na,
            num_strength=ns,
            num_coherence=nc,
            filter_len=fl,
            scale=sc,
            fidelity=fidelity,
            blend=blend,
        )
        return cls.from_numpy(filters, cfg, device)

    def train(self, hr_images: Sequence[np.ndarray] | bool = True, **kw) -> "RaisrModel":
        """Solve the bank from ``hr_images`` with ``train_filters`` (keywords
        ``ridge``, ``chunk``, ``augment``, ``device``). The bank lives on
        ``device``: by default the current bank's device, or the card when
        there is no bank yet. A bool is ``nn.Module.train``'s mode, so
        ``eval()`` and a parent module's ``train()`` keep working."""
        if isinstance(hr_images, bool):
            return super().train(hr_images)
        if self.filters is not None:
            kw.setdefault("device", self.filters.device)
        self.filters = train_filters(hr_images, self.cfg, **kw)
        return self

    def save(self, path: str) -> None:
        """The ``.npz`` layout both packages' ``load`` read."""
        np.savez_compressed(
            path,
            filters=self._bank().cpu().numpy(),
            cfg=np.array(
                [
                    self.cfg.num_angle,
                    self.cfg.num_strength,
                    self.cfg.num_coherence,
                    self.cfg.filter_len,
                    self.cfg.scale,
                ]
            ),
        )

    def _bank(self) -> torch.Tensor:
        if self.filters is None:
            raise ValueError("the model has no filter bank: train or load one first")
        return self.filters

    def upsample(self, img) -> torch.Tensor:
        """uint8 [H, W(, C)] or [B, H, W(, C)] in, uint8 at cfg.scale x out,
        on the model's device."""
        bank = self._bank()
        img = torch.as_tensor(img, device=bank.device)
        return raisr_upsample(img, bank, self.cfg)
