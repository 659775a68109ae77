"""Statistics of a run: percentiles over every sample and rates over the
window. No statistic here is built from medians of chunks or of calls."""

from __future__ import annotations

import math
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) of all ``values``, linear between the
    closest ranks (numpy's default 'linear' method)."""
    if not values:
        raise ValueError("percentile of no values")
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile {q} outside [0, 100]")
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(amount: float, seconds: float) -> float:
    """``amount`` per second over a window of ``seconds`` (> 0)."""
    if not seconds > 0.0:
        raise ValueError(f"a window of {seconds} s has no rate")
    return amount / seconds

