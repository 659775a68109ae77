"""Quality metrics (the JAX package's ``utils.metrics.psnr``)."""

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
