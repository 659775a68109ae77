"""Batched enhancement pipeline on one device.

Port of ``oclcomputervision_tpu/models/pipeline.py``: equalize ->
super-resolution -> resize -> pyramid over an image or a batch, resident on
one device end to end (the card unless the caller passes ``device="cpu"`` or
a CPU tensor). Each stage is the port's op: the histeq and RAISR kernels on
the card, their plain versions on the CPU. ``EnhancePipeline.sharded`` (the
data-parallel variant over a mesh) is not ported: it waits for the port of
``parallel/`` (ROADMAP queue A item 10).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from oclcomputervision_tpu_torch._device import as_tensor
from oclcomputervision_tpu_torch.ops.histeq import histeq_global, histeq_local_block
from oclcomputervision_tpu_torch.ops.interpolation import resize_uint8
from oclcomputervision_tpu_torch.ops.pyramid import gaussian_pyramid
from oclcomputervision_tpu_torch.ops.raisr import raisr_upsample
from oclcomputervision_tpu_torch.utils.config import HistEqConfig, LocalHistEqConfig


@dataclasses.dataclass(frozen=True)
class EnhanceConfig:
    """One config for the enhance pipeline."""

    equalize: str = "global"  # 'global' | 'local' | 'none'
    histeq: HistEqConfig = HistEqConfig()
    local: LocalHistEqConfig = LocalHistEqConfig()
    # 'raisr' runs learned super-resolution after equalize (pass the
    # trained RaisrModel to EnhancePipeline); 'none' skips it
    superres: str = "none"
    # output size (H, W) after resize, None = keep
    resize_to: Optional[Tuple[int, int]] = None
    resize_method: str = "bicubic"
    pyramid_depth: int = 0  # >0: also return a Gaussian pyramid


class EnhancePipeline:
    """Compose equalize -> superres -> resize -> pyramid.

    Works on uint8 [H, W] or batched [B, H, W] luma stacks; returns the
    output tensor, or (output, pyramid levels) when ``pyramid_depth`` > 0.
    """

    def __init__(self, cfg: EnhanceConfig = EnhanceConfig(), raisr_model=None):
        """``raisr_model``: a trained models.raisr.RaisrModel, required
        when cfg.superres == 'raisr' (one pipeline instance serves one bank)."""
        self.cfg = cfg
        if cfg.superres == "raisr":
            if raisr_model is None or raisr_model.filters is None:
                raise ValueError(
                    "cfg.superres='raisr' needs a trained RaisrModel "
                    "(EnhancePipeline(cfg, raisr_model=model))"
                )
            self._raisr_filters = raisr_model.filters
            self._raisr_cfg = raisr_model.cfg
        elif cfg.superres != "none":
            raise ValueError(f"unknown superres mode {cfg.superres!r}")

    def __call__(self, gray, *, device=None):
        """Run on ``gray``'s device (a tensor), or on ``device`` (None: the card)."""
        cfg = self.cfg
        x = as_tensor(gray, device)
        batched = x.ndim == 3  # [B, H, W] luma stack
        if cfg.equalize == "global":
            h = cfg.histeq
            x = histeq_global(x, h.alpha, h.punch, h.clip)
        elif cfg.equalize == "local":
            l = cfg.local
            x = histeq_local_block(x, l.alpha, l.punch, l.clip, l.blockshape)
        if cfg.superres == "raisr":
            # handles [H, W] and [B, H, W]; the bank follows the image
            x = raisr_upsample(x, self._raisr_filters.to(x.device), self._raisr_cfg)
        if cfg.resize_to is not None:
            x = resize_uint8(x, cfg.resize_to, cfg.resize_method, batched=batched)
        if cfg.pyramid_depth > 0:
            return x, gaussian_pyramid(x, 2, cfg.pyramid_depth, batched=batched)
        return x
