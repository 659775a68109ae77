"""Quality metrics (the JAX package's ``utils.metrics.psnr`` and ``epe``)."""

from __future__ import annotations

import numpy as np


def psnr(a, b, data_range: float = 255.0) -> float:
    """Peak signal-to-noise ratio between two arrays."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10((data_range**2) / mse))


def epe(flow, flow_gt, max_flow: float = 1e9) -> float:
    """Average endpoint error between two [H, W, 2] flow fields.

    Pixels whose ground-truth magnitude exceeds ``max_flow`` (Middlebury
    uses ~1e9 to mark unknown flow) are excluded.
    """
    flow = np.asarray(flow, dtype=np.float64)
    flow_gt = np.asarray(flow_gt, dtype=np.float64)
    valid = np.all(np.abs(flow_gt) < max_flow, axis=-1)
    d = np.sqrt(np.sum((flow - flow_gt) ** 2, axis=-1))
    return float(np.mean(d[valid]))
