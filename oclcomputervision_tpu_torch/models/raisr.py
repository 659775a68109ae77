"""RAISR model: the learned filter bank as an ``nn.Module``.

Port of ``oclcomputervision_tpu/models/raisr.RaisrModel``'s inference side:
``load`` reads the same ``.npz`` banks, ``upsample`` runs
``ops.raisr.raisr_upsample`` on the model's device, and ``from_numpy``
carries a JAX model's bank and config across
(``np.asarray(jax_model.filters)``, ``jax_model.cfg``). Training
(``accumulate_normal_eq``, ``solve_filters``, ``train_filters``) is not
ported yet. The model lives on the card unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from oclcomputervision_tpu_torch._device import as_device
from oclcomputervision_tpu_torch.ops.raisr import raisr_upsample
from oclcomputervision_tpu_torch.utils.config import RaisrConfig


def port_config(cfg) -> RaisrConfig:
    """The port's ``RaisrConfig`` with the fields of ``cfg``, which may be a
    config of another package (the JAX package's ``RaisrConfig``)."""
    return RaisrConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(RaisrConfig)})


class RaisrModel(nn.Module):
    """Filter bank [num_filters, fl, fl] f32 (a buffer) plus its config."""

    def __init__(self, cfg: RaisrConfig, filters: torch.Tensor):
        super().__init__()
        fl = cfg.filter_len
        if tuple(filters.shape) != (cfg.num_filters, fl, fl):
            raise ValueError(
                f"bank shape {tuple(filters.shape)} != {(cfg.num_filters, fl, fl)}"
            )
        self.cfg = cfg
        self.register_buffer("filters", filters.to(torch.float32))

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
        """Load a bank saved by the JAX package's ``RaisrModel.save``."""
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

    def upsample(self, img) -> torch.Tensor:
        """uint8 [H, W(, C)] or [B, H, W(, C)] in, uint8 at cfg.scale x out,
        on the model's device."""
        img = torch.as_tensor(img, device=self.filters.device)
        return raisr_upsample(img, self.filters, self.cfg)
