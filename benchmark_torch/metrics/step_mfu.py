"""The whole call's share of the chip's peak: its least time (the
configuration's counted operations over 67 TFLOP/s or its bytes moved once
over 3.35 TB/s, the larger) over the traced window's time per call, in %."""

from benchmark_torch.common.roofline import least_seconds


def read(run):
    if run.trace is None:
        return None
    return 100.0 * least_seconds(*run.counts["call"]) * run.window.calls / run.trace.window_s
