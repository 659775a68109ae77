"""Timing: CUDA-event device time of work on the card (``cuda_time_ms``), the
device's per-kernel profile (``device_profile``, ``device_trace``) and wall
times that end in a synchronise of the card (``timed``, ``Timer``,
``bench_op``: the JAX package's ``utils.profiling`` names)."""

from __future__ import annotations

import contextlib
import os
import statistics
import time
from typing import Any, Callable, Tuple

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


def _sync() -> None:
    """Wait for the card's work, where this process uses the card: the
    JAX package's block on a result."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timed(fn: Callable, *args, **kwargs) -> Tuple[Any, float]:
    """Run ``fn(*args, **kwargs)``; return (result, wall ms). Where this
    process uses the card, the clock stops after ``torch.cuda.synchronize``,
    so the time includes the device work of a result of any structure (a
    tensor, a list of flows). An exception of ``fn`` or of the synchronize
    propagates."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    _sync()
    return out, (time.perf_counter() - t0) * 1000.0


class Timer:
    """Accumulating wall-clock timer (milliseconds). ``measure()`` waits for
    the card's work (``torch.cuda.synchronize``) before it reads the clock at
    either end, where this process uses the card."""

    def __init__(self) -> None:
        self.total_ms = 0.0
        self.count = 0

    @contextlib.contextmanager
    def measure(self):
        _sync()
        t0 = time.perf_counter()
        yield
        _sync()
        self.total_ms += (time.perf_counter() - t0) * 1000.0
        self.count += 1

    @property
    def mean_ms(self) -> float:
        return self.total_ms / max(self.count, 1)


def bench_op(fn: Callable, *args, warmup: int = 2, iters: int = 20) -> float:
    """Median wall-clock ms of ``fn(*args)`` after ``warmup`` calls, each
    call ended by ``torch.cuda.synchronize`` where this process uses the
    card (the JAX package's contract: a blocking call's wall, host work
    included). ``cuda_time_ms`` is the device-time tool."""
    for _ in range(warmup):
        fn(*args)
        _sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        times.append((time.perf_counter() - t0) * 1000.0)
    times.sort()
    return times[len(times) // 2]


@contextlib.contextmanager
def device_trace(logdir: str):
    """Trace the region with ``torch.profiler`` (the host, and the card where
    torch sees one) and write it to ``logdir`` as a Chrome trace,
    ``trace.pt.trace.json``, which chrome://tracing and Perfetto read (the
    JAX package's ``device_trace``)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        _sync()
    prof.export_chrome_trace(os.path.join(logdir, "trace.pt.trace.json"))


PROFILE_WINDOWS = 3  # profiled windows device_profile tries before it fails
PROFILE_WINDOW = "device_profile.window"  # the host range around the profiled calls


def idle_share(busy, window) -> float:
    """1 - the share of ``window`` (start, end) that the union of the
    ``busy`` (start, end) intervals covers: overlaps count once, and time in
    the window before the first and after the last interval counts as idle."""
    w0, w1 = window
    covered, reach = 0.0, w0
    for s, e in sorted(busy):
        s, e = max(s, reach), min(e, w1)
        if e > s:
            covered += e - s
            reach = e
    return 1.0 - covered / (w1 - w0)


def device_profile(fn: Callable, *args, calls: int = 5) -> tuple[dict, float]:
    """Per-kernel device milliseconds per call of ``fn(*args)``, from
    ``torch.profiler``, and the device's idle share: the counterpart of the
    JAX package's ``profile_device``.

    Runs ``fn`` once to warm up, then ``calls`` times under the profiler.
    Returns ({kernel name: ms per call}, idle share). The device's activity
    is its kernels and copies, not the device ranges of annotations such as
    ``record_function``'s; the idle share is ``idle_share`` of that activity
    over the whole profiled window, from before the first call to the end
    of the synchronise after the last.
    A window in which the profiler delivered no device event at all is
    profiled again, up to ``PROFILE_WINDOWS`` windows: on the H100 the
    profiler has now and then returned none for a window whose kernels ran.
    Fails without a card, or when no window saw device activity.
    """
    from torch.profiler import ProfilerActivity, profile, record_function

    require_cuda()
    fn(*args)
    torch.cuda.synchronize()
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events, window = [], None
    for _ in range(PROFILE_WINDOWS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(PROFILE_WINDOW):
                for _ in range(calls):
                    fn(*args)
                torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == cuda
                  and not getattr(e, "is_user_annotation", False)]
        if events:
            window = next(e.time_range for e in prof.events()
                          if e.name == PROFILE_WINDOW and e.device_type == cpu)
            break
    if not events:
        raise RuntimeError(f"torch.profiler recorded no device activity in {PROFILE_WINDOWS} windows")
    per_kernel: dict = {}
    for e in events:
        per_kernel[e.name] = per_kernel.get(e.name, 0.0) + e.device_time / 1e3 / calls
    busy = [(e.time_range.start, e.time_range.end) for e in events]
    return per_kernel, idle_share(busy, (window.start, window.end))
