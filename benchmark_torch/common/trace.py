"""Host spans and the reading of ``torch.profiler``'s trace.

The harness opens its own spans around its calls into the program
(``SPANS``); in a traced run each is a ``record_function`` range, so it lies
on the profiler's clock beside the device's activity. ``Trace`` holds what
the per-layer readers need: the device's activity inside the traced window,
the spans, and the host clock's offset to the profiler's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Iterable, List, Sequence, Tuple

# what the harness's host does: the window, a call into the program, waiting
# (for the device, or for a frame's due time in the open loop), and the
# copies in and out of host memory ("host" io)
SPANS = ("window", "entry", "wait", "h2d", "d2h")
OUTSIDE = "harness"  # an idle gap under none of the spans
TOP = 10  # entries of each breakdown list

Interval = Tuple[float, float]  # seconds on the profiler's clock


class Spans:
    """Context managers for the harness's spans: ``record_function`` ranges
    in a traced run, nothing otherwise."""

    def __init__(self, traced: bool):
        self.traced = traced

    def __call__(self, name: str):
        if not self.traced:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(name)


@dataclasses.dataclass
class Trace:
    window: Interval  # the "window" span
    ops: List[Tuple[str, float, float]]  # device activity (kernels, copies, sets) in the window
    spans: List[Tuple[str, float, float]]  # the harness's spans
    host_offset: float  # profiler seconds minus host perf_counter seconds

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def kernels(self) -> List[Tuple[str, float, float]]:
        """Device kernels only (no copies or sets)."""
        return [op for op in self.ops if not op[0].startswith(("Memcpy", "Memset"))]

    def busy(self) -> List[Interval]:
        return union((s, e) for _, s, e in self.ops)

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy())

    def device_ops(self) -> list:
        """[[kernel name, seconds], ...]: the device operations that took most time."""
        total: dict = {}
        for name, s, e in self.ops:
            total[name] = total.get(name, 0.0) + (e - s)
        return [[n, t] for n, t in sorted(total.items(), key=lambda kv: -kv[1])[:TOP]]

    def idle_gaps(self) -> list:
        """[[span name, seconds], ...]: the device's idle time in the window,
        by the innermost span open at each gap's middle, most first."""
        total: dict = {}
        spans = sorted((s for s in self.spans if s[0] != "window"), key=lambda sp: sp[2] - sp[1])
        for s, e in gaps(self.busy(), self.window):
            mid = 0.5 * (s + e)
            name = next((n for n, a, b in spans if a <= mid <= b), OUTSIDE)
            total[name] = total.get(name, 0.0) + (e - s)
        return [[n, t] for n, t in sorted(total.items(), key=lambda kv: -kv[1])[:TOP]]


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """Sorted disjoint intervals covering ``intervals``."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def overlap(disjoint: Sequence[Interval], a: float, b: float) -> float:
    """Length of [a, b] covered by sorted disjoint intervals."""
    return sum(max(0.0, min(e, b) - max(s, a)) for s, e in disjoint if e > a and s < b)


def gaps(disjoint: Sequence[Interval], window: Interval) -> List[Interval]:
    """The parts of ``window`` that sorted disjoint intervals leave uncovered."""
    out, t = [], window[0]
    for s, e in disjoint:
        if s > t:
            out.append((t, min(s, window[1])))
        t = max(t, e)
        if t >= window[1]:
            break
    if t < window[1]:
        out.append((t, window[1]))
    return [(s, e) for s, e in out if e > s]


def named(ops: Iterable[Tuple[str, float, float]], kernel: str) -> List[Tuple[str, float, float]]:
    """The device operations of kernel ``kernel`` (a CUDA function name, as
    ``raisr_apply_kernel``), by whole word in the profiler's name."""
    pat = re.compile(rf"\b{re.escape(kernel)}\b")
    return [op for op in ops if pat.search(op[0])]


def read_profile(prof, host_window_start: float) -> Trace:
    """The ``Trace`` of a finished ``torch.profiler.profile``; the window
    span opened at ``host_window_start`` on the host's perf_counter."""
    import torch

    spans, device = [], []
    for ev in prof.events():
        s, e = ev.time_range.start * 1e-6, ev.time_range.end * 1e-6
        if ev.name in SPANS or getattr(ev, "is_user_annotation", False):
            if ev.device_type == torch.autograd.DeviceType.CPU and ev.name in SPANS:
                spans.append((ev.name, s, e))
            continue
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            device.append((ev.name, s, e))
    windows = [sp for sp in spans if sp[0] == "window"]
    if len(windows) != 1:
        raise RuntimeError(f"the trace holds {len(windows)} window spans, not 1")
    _, w0, w1 = windows[0]
    ops = [(n, max(s, w0), min(e, w1)) for n, s, e in device if e > w0 and s < w1]
    return Trace((w0, w1), ops, spans, w0 - host_window_start)
