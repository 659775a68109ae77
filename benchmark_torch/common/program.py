"""The program's own spans and ``syncs`` counter
(``oclcomputervision_tpu_torch.utils.tracing``) beside the harness's
``Trace``: what the readers that look inside a call read.

The tracer records while a profiler runs, and the harness runs one from
after the warm-up to the end of the window, so after a traced run the
record holds the window's sampled calls (one in ``tracing.SAMPLE_EVERY``):
those whose outermost span opened inside the window, on the profiler's
clock by ``Trace.host_offset``. Every reader returns None where the record
has none: an untraced run, the CPU rehearsal, or a program without the
tracer.

The idle a sync leaves is found on the device's own track, where the copy
it waits on ends, and not by its host time: within a window the profiler's
host and device clocks drift apart (on the H100, by tens of microseconds
in most 5 s windows and by 7.7 ms in one), against drain gaps of 0.03-0.2
ms.
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Tuple

from benchmark_torch.common.trace import gaps

PREFIX = "ocv."  # the program's span names
# a device copy to or from pageable host memory: the host waits for it, so
# once it ends the queue is empty until the host launches again
PAGEABLE = "Pageable"


def records() -> list:
    """The program's closed spans, in the order they opened ([] where the
    program has no tracer)."""
    try:
        from oclcomputervision_tpu_torch.utils import tracing
    except ImportError:
        return []
    return [r for r in tracing.records() if r.name.startswith(PREFIX) and r.t1 is not None]


def window_calls(run) -> Optional[Tuple[list, int]]:
    """(the spans of the window's sampled calls, their number), or None
    where there are none."""
    if run.trace is None or not run.window.calls:
        return None
    recs = records()
    off, (w0, w1) = run.trace.host_offset, run.trace.window
    calls = {r.call for r in recs if r.parent is None and w0 <= r.t0 + off <= w1}
    if not calls:
        return None
    return [r for r in recs if r.call in calls], len(calls)


def syncs_per_call(run) -> Optional[float]:
    """The ``syncs`` counter summed over the window's sampled calls, per
    sampled call."""
    got = window_calls(run)
    if got is None:
        return None
    spans, calls = got
    return sum(len(r.syncs) for r in spans) / calls


def sync_idle(trace) -> List[tuple]:
    """The window's idle gaps that open where a copy to or from pageable
    host memory ends: the drain that a synchronising copy leaves, to the
    host's next launch. A copy that the device runs on into other work
    opens none."""
    idle = gaps(trace.busy(), trace.window)
    starts = [s for s, _ in idle]
    out = []
    for name, _, end in trace.ops:
        if PAGEABLE in name:
            k = bisect.bisect_left(starts, end)
            if k < len(idle) and idle[k][0] == end:
                out.append(idle[k])
    return out


def sync_idle_ms_per_call(run) -> Optional[float]:
    """``sync_idle`` in ms per call of the window, where the record has a
    sampled call in it."""
    if window_calls(run) is None:
        return None
    return 1e3 * sum(e - s for s, e in sync_idle(run.trace)) / run.window.calls
