"""The port's stage spans and its ``syncs`` counter, on exactly while a
profiler runs.

``span(name)`` marks one stage of a call; the names start with ``ocv.``.
With no profiler active (``torch.autograd._profiler_enabled()`` false) it
returns one shared no-op context: no allocation, no clock read, no CUDA
call and no profiler range. While one is active (``torch.profiler.profile``,
``utils.profiling.device_trace`` or ``device_profile``) the tracer samples
the calls: the first of every ``SAMPLE_EVERY`` (a call is an outermost
span) is traced whole, and in the others every span is a no-op but the
outermost, which only marks the call open. On the card each span's host
work lands where the card waits on the host, right after a sync, so
tracing every call would add that idle to every call. In a sampled call a
span

- opens a profiler range of its name, the C++ form of ``record_function``
  (``torch._C._profiler._RecordFunctionFast``): a host range on the calling
  thread of the trace, from whose launches the profiler draws its arrows to
  the kernels they started;
- appends itself to the record (``Span``): its name, its call (the sequence
  number of the outermost span among all calls), the record index of its
  parent, its host start and end on ``time.perf_counter()`` and ``syncs``,
  the host times of the synchronising CUDA calls made while it was the
  innermost open span;
- touches nothing on the card: no event, no launch, no allocation;
- given a CUDA device (``span(name, alloc=device)``), records in
  ``alloc_bytes`` the bytes the card's caching allocator hands out on that
  device while the span is open: the difference of the allocator's
  cumulative ``allocated_bytes.all.allocated`` statistic across the span,
  read on the host with no CUDA call. Otherwise ``alloc_bytes`` is None.

Syncs are caught with the card's sync debug mode at "warn", under which
every synchronising CUDA call raises the warning ``SYNC_WARNING``. The
hook that counts them, an "always" filter on that text and a
``warnings.showwarning`` that counts it on the innermost open span and hands
every other warning on unchanged, is put in once per profiling session, by
its first span. The outermost span of a sampled call turns the debug mode
on at its entry and back at its exit, where the process uses the card (and
only where the mode was off), so the mode is never left on outside a
sampled call. The first span that finds the profiler off again, or
``reset()``, takes the hook out and leaves the filters and ``showwarning``
as they were.

``records()`` returns the record, the sampled calls' spans, and ``reset()``
clears it. The first span of a profiling session clears it too, so after a
profiled run the record holds that session's sampled calls. One thread
makes the calls.
"""

from __future__ import annotations

import contextlib
import time
import warnings
from typing import List, Optional

import torch

_RANGE = torch._C._profiler._RecordFunctionFast
_profiling = torch.autograd._profiler_enabled
_clock = time.perf_counter

# the text of the warning each synchronising CUDA call gives in "warn" mode
SYNC_WARNING = "called a synchronizing CUDA operation"
# the warning torch gives once, at the first change of the debug mode
_PROTOTYPE = "Synchronization debug mode is a prototype"
_OFF = contextlib.nullcontext()
SAMPLE_EVERY = 16  # the tracer traces the first call of every SAMPLE_EVERY


class Span:
    """One span of the record, and the context manager ``span`` returns
    while a profiler is active. ``t0`` is read just after the profiler range
    opens and ``t1`` just before it closes."""

    __slots__ = ("name", "call", "parent", "t0", "t1", "syncs", "alloc_bytes", "_alloc", "_range")

    def __init__(self, name: str, alloc: Optional[torch.device] = None):
        self.name = name
        self.call: Optional[int] = None
        self.parent: Optional[int] = None  # record index of the enclosing span
        self.t1: Optional[float] = None
        self.syncs: List[float] = []  # host times of the syncs while innermost
        self.alloc_bytes: Optional[int] = None  # bytes allocated on ``alloc`` while open
        self._alloc = alloc if alloc is not None and alloc.type == "cuda" else None

    def __enter__(self) -> "Span":
        tr = _TRACER
        open_, record = tr.open, tr.record
        self.call = tr.calls - 1  # ``span`` counted the call
        if open_:
            self.parent = open_[-1]
        self._range = r = _RANGE(self.name)
        r.__enter__()
        outermost = not open_
        open_.append(len(record))
        record.append(self)
        self.t0 = _clock()
        # after t0, which is read as the range opens
        if outermost and torch.cuda.is_initialized() and torch.cuda.get_sync_debug_mode() == 0:
            tr.mode = 0
            torch.cuda.set_sync_debug_mode("warn")
        if self._alloc is not None:
            self.alloc_bytes = -_allocated(self._alloc)
        return self

    def __exit__(self, *exc) -> bool:
        if self._alloc is not None:
            self.alloc_bytes += _allocated(self._alloc)
        self.t1 = _clock()
        self._range.__exit__(None, None, None)
        self._range = None
        tr = _TRACER
        tr.open.pop()
        if not tr.open and tr.mode is not None:
            torch.cuda.set_sync_debug_mode(tr.mode)
            tr.mode = None
        return False

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, call={self.call}, parent={self.parent}, "
                f"t0={self.t0}, t1={self.t1}, syncs={self.syncs}, "
                f"alloc_bytes={self.alloc_bytes})")


def _allocated(device: torch.device) -> int:
    """The caching allocator's cumulative bytes handed out on ``device``
    (``torch.cuda.memory_stats(device)["allocated_bytes.all.allocated"]``)."""
    return torch.cuda.memory_stats_as_nested_dict(device)["allocated_bytes"]["all"]["allocated"]


class _Tracer:
    """The record, the open spans and the sync hook of a session."""

    def __init__(self) -> None:
        self.record: List[Span] = []
        self.open: List[int] = []  # record indices of the open spans, outermost first
        self.skipping = False  # a call that is not sampled is open
        self.calls = 0  # calls begun since the record was cleared
        self.hook = None  # (filters added, showwarning found, ours) during a session
        self.mode: Optional[int] = None  # the debug mode the open call turned from

    def start(self) -> None:
        """A session's first span: a new record, and the sync hook."""
        self.record.clear()
        self.calls = 0
        found = warnings.showwarning
        record, open_ = self.record, self.open

        def show(message, category, filename, lineno, file=None, line=None):
            if open_ and str(message).startswith(SYNC_WARNING):
                record[open_[-1]].syncs.append(_clock())
            else:
                found(message, category, filename, lineno, file, line)

        warnings.filterwarnings("ignore", message=_PROTOTYPE)
        warnings.filterwarnings("always", message=SYNC_WARNING)
        self.hook = (warnings.filters[:2], found, show)
        warnings.showwarning = show

    def stop(self) -> None:
        """Take the sync hook out."""
        added, found, show = self.hook
        self.hook = None
        for f in added:
            if f in warnings.filters:
                warnings.filters.remove(f)
        warnings._filters_mutated()
        if warnings.showwarning is show:
            warnings.showwarning = found


_TRACER = _Tracer()


class _Skip:
    """The outermost span of a call that is not sampled: it marks the call
    open, so that the spans inside it are no-ops too."""

    __slots__ = ()

    def __enter__(self) -> None:
        _TRACER.skipping = True

    def __exit__(self, *exc) -> bool:
        _TRACER.skipping = False
        return False


_SKIP = _Skip()


def span(name: str, alloc: Optional[torch.device] = None):
    """A context manager for stage ``name``: the shared no-op unless a
    profiler is active and the call is sampled (module docstring). ``alloc``:
    the device whose allocations the span counts (only a CUDA one is)."""
    tr = _TRACER
    if not _profiling():
        if tr.hook is not None and not tr.open:
            tr.stop()
        return _OFF
    if tr.open:
        return Span(name, alloc)
    if tr.skipping:
        return _OFF
    if tr.hook is None:
        tr.start()
    tr.calls += 1
    return _SKIP if (tr.calls - 1) % SAMPLE_EVERY else Span(name, alloc)


def records() -> List[Span]:
    """The spans of the calls sampled since the session's first span or
    ``reset()``, in the order they opened (a copy)."""
    return list(_TRACER.record)


def reset() -> None:
    """Clear the record and take the sync hook out; not inside an open span."""
    if _TRACER.open or _TRACER.skipping:
        raise RuntimeError("tracing.reset() inside an open span")
    _TRACER.record.clear()
    _TRACER.calls = 0
    if _TRACER.hook is not None:
        _TRACER.stop()
