"""One run of one cell: discovery of its parts by name, set-up, the
measured window, the readers of its metrics and the comparison that
decides ``correct``.

Every part is found by the name ``BENCHMARK.json`` gives it, so that a
later change adds a configuration, a traffic mix or a metric as new files:

- ``configs/<config>.json`` (the settings as run) and ``configs/<config>.py``
  (``build``, ``flatten``, ``reference``, ``control``, ``plant``,
  ``out_pixels``, ``counts``, ``compare``);
- ``traffic/<traffic>.json`` (read by ``common/traffic.py``), the driver
  of its window that it names, ``loops/<loop>.py``, and the content of its
  items, ``content/<content>.py`` (found by ``common/modules.py``);
- ``metrics/<metric>.py`` (``read(run) -> float | None``; None leaves the
  metric out of the line).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Optional

import torch

from benchmark_torch.common import traffic as tr
from benchmark_torch.common.modules import BENCH_DIR, load_module
from benchmark_torch.common.trace import Spans, Trace, read_profile

# a traced run measures at most this long: reading the profiler's events
# takes about 10 s per traced second in the batch cells, and a run has to
# end within 360 s
TRACE_SECONDS = 5.0
ROOT = os.path.dirname(BENCH_DIR)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with its parts loaded."""

    name: str
    chips: int
    spec: dict  # configs/<config>.json
    config: object  # configs/<config>.py
    mix: dict  # traffic/<traffic>.json
    end_to_end: list  # the entries of BENCHMARK.json's end_to_end this cell reports
    per_layer: list


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(bench: dict, name: str, rehearse: bool = False) -> Cell:
    """The workload ``name`` with its configuration, traffic and metrics;
    ``rehearse`` applies the files' ``rehearsal`` keys (tiny CPU sizes)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    return assemble(bench, cells[name], rehearse)


def assemble(bench: dict, w: dict, rehearse: bool = False) -> Cell:
    """The cell of a workload entry ``w`` (name, config, traffic, chips),
    which need not be one of ``bench``'s."""
    name = w["name"]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    spec = _load_json(os.path.join(ROOT, conf["file"]))
    module = load_module(os.path.join(BENCH_DIR, "configs", f"{w['config']}.py"),
                         f"benchmark_torch.configs.{w['config']}")
    mix = _load_json(os.path.join(BENCH_DIR, "traffic", f"{w['traffic']}.json"))
    if rehearse:
        spec = {**spec, **spec.get("rehearsal", {})}
        mix = {**mix, **mix.get("rehearsal", {})}
    return Cell(name, w["chips"], spec, module, mix,
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)])


def load_loop(loop: str) -> Callable:
    """``run`` of ``loops/<loop>.py``, the driver of a window."""
    return load_module(os.path.join(BENCH_DIR, "loops", f"{loop}.py"),
                       f"benchmark_torch.loops.{loop}").run


def load_reader(metric: str) -> Callable:
    path = os.path.join(BENCH_DIR, "metrics", f"{metric}.py")
    return load_module(path, "benchmark_torch.metrics." + metric.replace(".", "_")).read


@dataclasses.dataclass
class Run:
    """What a metric's reader reads."""

    cell: Cell
    setup_s: float
    window: tr.Window
    frames_per_call: int
    out_px_per_frame: int
    counts: dict  # the configuration's counts of one call
    own_kernels: frozenset  # CUDA function names of the program's hand-written kernels
    memory_peak_bytes: Optional[int] = None  # the card's allocator peak (None on the CPU)
    trace: Optional[Trace] = None


def _own_kernels() -> frozenset:
    """The CUDA function names of the program's hand-written kernels (the
    keys of its launch counter, ``kernels._build.LAUNCHES``)."""
    from oclcomputervision_tpu_torch.kernels import _build

    return frozenset(f"{k}_kernel" for k in _build.LAUNCHES)


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device, t_start: float,
             entry: Optional[Callable] = None, rate_hz: Optional[float] = None):
    """Set up, measure for ``seconds``, then compare. Returns (the Run, the
    compared numbers {name: (value, limit)}).
    ``entry`` replaces the program's (the control, which takes a batch: a
    mix of batch 0 hands it each item as a batch of one); ``rate_hz`` the
    open loop's rate (0: back to back)."""
    spec, mix, cfg = cell.spec, cell.mix, cell.config
    if entry is None:
        entry = cfg.build(spec, device)
    elif mix["batch"] == 0:
        entry = _one_item(entry)
    pool = tr.make_inputs(mix, seed, device)
    loop = load_loop(mix["loop"])
    tr.warm_up(entry, cfg.flatten, pool, mix, device, Spans(False))
    spans = Spans(traced)
    kwargs = {} if rate_hz is None else {"rate_hz": rate_hz}
    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    setup_s = time.perf_counter() - t_start
    with spans("window"):
        host_start = time.perf_counter()
        window = loop(entry, cfg.flatten, pool, mix, min(seconds, TRACE_SECONDS) if traced
                      else seconds, seed, device, spans, **kwargs)
    trace = None
    if prof is not None:
        prof.__exit__(None, None, None)
        trace = read_profile(prof, host_start)
        del prof
    peak = None
    if torch.device(device).type == "cuda":
        peak = torch.cuda.max_memory_allocated(device)
    run = Run(cell, setup_s, window, max(mix["batch"], 1),
              cfg.out_pixels(spec, mix["frame"]), cfg.counts(spec, max(mix["batch"], 1), mix["frame"]),
              _own_kernels(), peak, trace)
    # let the program's state go before the reference runs: keep only the
    # kept calls' inputs and outputs
    kept = [(pool[idx], outs) for _, idx, outs in window.kept]
    window.kept = []
    del entry, pool
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return run, check(cell, kept, device)


def _one_item(batched: Callable) -> Callable:
    """``batched`` called on one item: the item as a batch of one, and every
    tensor of the result back to its one item."""
    def first(out):
        if isinstance(out, torch.Tensor):
            return out[0]
        return type(out)(first(o) for o in out)
    return lambda x: first(batched(x[None]))


def check(cell: Cell, kept: list, device) -> dict:
    """The comparison with the plain reference, once the window has closed:
    the reference runs on each kept call's inputs. {name: (worst value over
    the kept calls, limit)}. A mix of batch 0 sends one item a call, which
    the reference takes as a batch of one."""
    spec, cfg = cell.spec, cell.config
    one = cell.mix["batch"] == 0
    worst: dict = {}
    for x, outs in kept:
        x = x if isinstance(x, torch.Tensor) else torch.from_numpy(x).to(device)
        prog = [torch.as_tensor(o).to(device) for o in outs]
        prog = [p[None] for p in prog] if one else prog
        for name, v in cfg.compare(spec, prog, cfg.reference(spec, x[None] if one else x)).items():
            worst[name] = max(worst.get(name, v), v)
    limits = spec.get("limits", {})
    return {name: (v, limits.get(name)) for name, v in worst.items()}


def is_correct(checks: dict) -> bool:
    """Every number within its limit; a number without a limit fails."""
    return bool(checks) and all(lim is not None and v <= lim for v, lim in checks.values())
