"""The program's allocation counter (``alloc_bytes`` of its spans,
``oclcomputervision_tpu_torch.utils.tracing``): the bytes the card's caching
allocator handed out inside a span of a sampled call."""

from __future__ import annotations

from typing import Optional

from benchmark_torch.common.program import window_calls


def span_gb_per_call(run, name: str) -> Optional[float]:
    """``alloc_bytes`` summed over the spans ``name`` of the window's
    sampled calls, per sampled call, in GB (1e9 bytes). None where the
    record has no such span with a reading: an untraced run, the CPU, a
    call that does not run the stage, or a program without the counter."""
    got = window_calls(run)
    if got is None:
        return None
    spans, calls = got
    read = [r.alloc_bytes for r in spans
            if r.name == name and getattr(r, "alloc_bytes", None) is not None]
    if not read:
        return None
    return sum(read) / calls / 1e9
