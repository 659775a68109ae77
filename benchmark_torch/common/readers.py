"""Arithmetic that more than one metric reader shares."""

from __future__ import annotations

from benchmark_torch.common.roofline import least_seconds
from benchmark_torch.common.stats import percentile
from benchmark_torch.common.trace import named


def frame_latency_ms(run, q: float):
    """The q-th percentile over every frame of the window of the time from
    its due time to its result (None in a closed loop)."""
    frames = run.window.frames
    if not frames:
        return None
    return percentile([(done - due) * 1e3 for due, _, _, _, done in frames], q)


def kernel_roofline_pct(run, kernel: str):
    """``kernel``'s least time (the configuration's bytes and operations
    over the chip's peaks) over its own device time, per call, in %."""
    if run.trace is None or kernel not in run.counts["kernels"]:
        return None
    ops = named(run.trace.ops, f"{kernel}_kernel")
    if not ops:
        return None
    device_s = sum(e - s for _, s, e in ops)
    return 100.0 * least_seconds(*run.counts["kernels"][kernel]) * run.window.calls / device_s
