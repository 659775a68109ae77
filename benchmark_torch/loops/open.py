"""The open loop: frames due every 1 / rate_hz s (``mix["rate_hz"]`` unless
given; 0 sends each frame as soon as the one before it is done, which finds
the knee), in bursts of ``mix["burst"]`` frames (1 by default) at the same
mean rate. A frame's latency runs from its due time to its result in host
memory ("host" io) or on the card ("device" io)."""

from __future__ import annotations

import time
from typing import Optional

from benchmark_torch.common.traffic import Reservoir, Window, sync, to_card, to_host


def due_times(t0: float, period: float, burst: int):
    """The due time of frame i: every frame of a burst is due at its start."""
    return lambda i: t0 + (i // burst) * burst * period


def run(entry, flatten, pool, mix, seconds, seed, device, spans,
        rate_hz: Optional[float] = None) -> Window:
    rate = mix["rate_hz"] if rate_hz is None else rate_hz
    period = 1.0 / rate if rate else 0.0
    keep = Reservoir(mix["sample"], seed)
    frames = []
    t0 = time.perf_counter()
    due_of = due_times(t0, period, mix.get("burst", 1))
    i = 0
    while True:
        due = due_of(i) if period else time.perf_counter()
        if due - t0 >= seconds:
            break
        with spans("wait"):
            # spin, not sleep: a sleeping thread woke up to 14 ms late on the
            # card's host, and those late starts became the tail
            while time.perf_counter() < due:
                pass
        idx = i % len(pool)
        t_in = time.perf_counter()
        x = to_card(pool[idx], mix, device, spans)
        t_call = time.perf_counter()
        with spans("entry"):
            out = entry(x)
        t_ret = time.perf_counter()
        outs = to_host(flatten(out), mix, spans)
        if mix["io"] != "host":
            with spans("wait"):
                sync(device)
        frames.append((due, t_in, t_call, t_ret, time.perf_counter()))
        keep.offer((i, idx, outs))
        i += 1
    sync(device)
    return Window(t0, max(f[4] for f in frames), i, frames, keep.items)
