"""The general traffic generator. A mix is a data file,
``benchmark_torch/traffic/<name>.json``, whose inputs ``make_inputs`` makes
and whose ``loop`` names the driver of its window,
``benchmark_torch/loops/<loop>.py`` (``run(entry, flatten, pool, mix,
seconds, seed, device, spans, **kw) -> Window``):

- ``loop``: "closed" (one caller; the next call goes in when the oldest of
  ``in_flight`` calls has completed) or "open" (frames due every
  1 / ``rate_hz`` s, on schedule whatever came before, in bursts of
  ``burst`` frames at that mean rate, 1 by default; a late frame starts as
  soon as the one before it has its result);
- ``content``: what an item holds, ``benchmark_torch/content/<content>.py``
  (``make`` and ``PLANES``, the [h, w] planes of one item); "lenna", single
  frames, where the mix names none;
- ``frame``: [h, w] of the uint8 gray planes;
- ``batch``: items a call ([batch, *item]); 0 sends the items one at a time;
- ``io``: "device" (the inputs live on the card and the outputs stay
  there) or "host" (numpy frames in host memory; each call's input is
  copied to the card inside the window, and its main output comes back to
  host memory before the call counts as complete);
- ``pool_bytes`` (every plane counted) or ``pool_frames`` (items): distinct
  items drawn from the seed, used in turn (a pool of several times the L2's
  50 MB finds every call's input cold, as new images would);
- ``warmup``: calls before the window; ``sample``: how many calls
  (frames) of the window a seeded reservoir keeps for the comparison;
- ``rehearsal``: keys replaced in the CPU rehearsal.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Callable, List

import torch

from benchmark_torch.common.content import generator
from benchmark_torch.common.modules import load_content
from benchmark_torch.common.trace import Spans


@dataclasses.dataclass
class Window:
    """What the host clock saw in the measured window."""

    t0: float  # perf_counter at the window's start
    t_end: float  # when the last call's result was complete
    calls: int
    # open loop, per frame: (due, h2d start, entry start, entry return, done)
    frames: List[tuple] = dataclasses.field(default_factory=list)
    kept: list = dataclasses.field(default_factory=list)  # [(call index, pool index, outputs)]

    @property
    def seconds(self) -> float:
        return self.t_end - self.t0


class Reservoir:
    """A uniform sample of ``k`` of the offered items, its choices drawn
    from the seed (Vitter's algorithm R): no more than ``k`` are held."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.seen, self.items = k, random.Random(seed), 0, []

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.items[j] = item
        self.seen += 1


def make_inputs(mix: dict, seed: int, device) -> list:
    """The pool: uint8 tensors [batch, *item] ([*item] for batch 0) on the
    card for "device" io, numpy arrays for "host" io."""
    content = load_content(mix.get("content", "lenna"))
    h, w = mix["frame"]
    per_call = max(mix["batch"], 1)
    if "pool_frames" in mix:
        n_calls = -(-mix["pool_frames"] // per_call)
    else:
        n_calls = -(-mix["pool_bytes"] // (per_call * content.PLANES * h * w))
    gen = generator(seed, device)
    pool = []
    for _ in range(n_calls):
        x = content.make(gen, per_call, h, w, device)
        x = x if mix["batch"] else x[0]
        pool.append(x.cpu().numpy() if mix["io"] == "host" else x.contiguous())
    return pool


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def marker(device):
    """An event on the current stream (None on the CPU, where calls are
    synchronous)."""
    if torch.device(device).type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record()
    return ev


def to_card(x, mix: dict, device, spans: Spans):
    """A call's input on the card: "host" io copies the numpy frames in."""
    if mix["io"] != "host":
        return x
    with spans("h2d"):
        return torch.from_numpy(x).to(device)


def to_host(outs: list, mix: dict, spans: Spans) -> list:
    """A call's outputs as the caller holds them: "host" io copies the main
    output back to host memory (which waits for the call to complete)."""
    if mix["io"] != "host":
        return outs
    with spans("d2h"):
        return [outs[0].cpu().numpy(), *outs[1:]]


def warm_up(entry: Callable, flatten: Callable, pool: list, mix: dict, device,
            spans: Spans) -> None:
    """Run every shape of the window: ``warmup`` calls, holding as many
    outputs at once as the window's reservoir and pipeline do, so that the
    allocator holds that much before the window opens."""
    held = []
    for i in range(max(mix["warmup"], mix["sample"] + mix.get("in_flight", 1) + 1)):
        held.append(to_host(flatten(entry(to_card(pool[i % len(pool)], mix, device, spans))),
                            mix, spans))
    sync(device)
    del held
