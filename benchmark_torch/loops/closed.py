"""The closed loop: one caller with ``in_flight`` calls queued on the card.
Calls start until ``seconds`` have passed, and the window ends when the
last is complete. With "host" io each call's main output comes back to
host memory before the next call goes in."""

from __future__ import annotations

import collections
import time

from benchmark_torch.common.traffic import Reservoir, Window, marker, sync, to_card, to_host


def run(entry, flatten, pool, mix, seconds, seed, device, spans) -> Window:
    keep = Reservoir(mix["sample"], seed)
    pending = collections.deque()
    calls = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        idx = calls % len(pool)
        x = to_card(pool[idx], mix, device, spans)
        with spans("entry"):
            out = entry(x)
        outs = to_host(flatten(out), mix, spans)
        pending.append(marker(device))
        keep.offer((calls, idx, outs))
        calls += 1
        if len(pending) >= mix.get("in_flight", 1):
            ev = pending.popleft()
            if ev is not None:
                with spans("wait"):
                    ev.synchronize()
    with spans("wait"):
        sync(device)
    return Window(t0, time.perf_counter(), calls, kept=keep.items)
