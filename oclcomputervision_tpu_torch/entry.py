"""Entry point: the flagship RAISR x2 inference step, on the card by default.

Counterpart of ``__graft_entry__.entry()``: the same 64x64 uint8 image and
the same seeded filter bank (identity plus 0.01 noise), on ``device`` (None:
the card; ``"cpu"`` runs the plain versions).
"""

from __future__ import annotations

import numpy as np
import torch

from oclcomputervision_tpu_torch._device import as_device
from oclcomputervision_tpu_torch.ops.raisr import raisr_upsample
from oclcomputervision_tpu_torch.utils.config import RaisrConfig


def entry(device=None):
    """Returns (fn, (image, filter_bank)); ``fn(*args)`` upsamples x2."""
    dev = as_device(device)
    cfg = RaisrConfig(fidelity="full")
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, size=(64, 64), dtype=np.uint8)
    filters = rng.standard_normal(
        (cfg.num_filters, cfg.filter_len, cfg.filter_len)
    ).astype(np.float32) * 0.01
    filters[:, cfg.filter_len // 2, cfg.filter_len // 2] += 1.0

    def fn(image_u8, filter_bank):
        return raisr_upsample(image_u8, filter_bank, cfg)

    return fn, (torch.from_numpy(img).to(dev), torch.from_numpy(filters).to(dev))
