"""CUDA-event timing of work on the card."""

from __future__ import annotations

import statistics
from typing import Callable

import torch

from oclcomputervision_tpu_torch._device import require_cuda


def cuda_time_ms(fn: Callable, *args, warmup: int = 2, iters: int = 5) -> float:
    """Median device milliseconds of ``fn(*args)`` on the current stream.

    ``warmup`` calls first; then each of ``iters`` runs sits between two
    CUDA events, and ``torch.cuda.synchronize()`` precedes every reading of
    them. Fails without a card: a CPU time is never a device time.
    """
    require_cuda()
    if iters < 1:
        raise ValueError("iters must be >= 1")
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


PROFILE_WINDOWS = 3  # profiled windows device_profile tries before it fails


def device_profile(fn: Callable, *args, calls: int = 5) -> tuple[dict, float]:
    """Per-kernel device milliseconds per call of ``fn(*args)``, from
    ``torch.profiler``, and the device's idle share.

    Runs ``fn`` once to warm up, then ``calls`` times under the profiler.
    Returns ({kernel name: ms per call}, idle share), where the idle share
    is 1 - (summed kernel time) / (first kernel start to last kernel end).
    A window in which the profiler delivered no device event at all is
    profiled again, up to ``PROFILE_WINDOWS`` windows: on the H100 the
    profiler has now and then returned none for a window whose kernels ran.
    Fails without a card, or when no window saw device activity.
    """
    from torch.profiler import ProfilerActivity, profile

    require_cuda()
    fn(*args)
    torch.cuda.synchronize()
    events = []
    for _ in range(PROFILE_WINDOWS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn(*args)
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            break
    if not events:
        raise RuntimeError(f"torch.profiler recorded no device activity in {PROFILE_WINDOWS} windows")
    per_kernel: dict = {}
    for e in events:
        per_kernel[e.name] = per_kernel.get(e.name, 0.0) + e.device_time / 1e3 / calls
    busy_us = sum(e.device_time for e in events)
    span_us = max(e.time_range.end for e in events) - min(e.time_range.start for e in events)
    return per_kernel, 1.0 - busy_us / span_us
