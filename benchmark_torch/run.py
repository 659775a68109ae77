#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 benchmark_torch/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks for.
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device`` and, traced,
``breakdown``; ``checks`` comes last, each compared number beside its
limit, and the same numbers end standard error. Without a CUDA card (or
with fewer than the cell asks for) it exits 2 and prints no result; with
JAX or the JAX package loaded in the process once the window has closed, it
names them on standard error, exits 3 and prints no result.

``--rehearse`` runs the same control flow on the CPU at the tiny sizes of
the files' ``rehearsal`` keys, with the program's plain versions; its line
holds no metric and no device.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up is timed from here, before any import

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = os.path.join(ROOT, "build")
# fixed cache directories inside the checkout, so that only a cell's first
# run there builds anything (the kernel library itself builds into
# build/ocv_torch_kernels, where kernels/_build.py puts it)
CACHES = {"TRITON_CACHE_DIR": "triton_cache", "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "CUDA_CACHE_PATH": "cuda_cache"}
# top-level modules that no run may hold: JAX and the JAX package the port
# was made from (whole names: the port's own begins with the latter's)
BARRED = frozenset({"jax", "jaxlib", "flax", "oclcomputervision_tpu"})


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", action="store_true",
                    help="CPU rehearsal at tiny sizes; prints no metric")
    return ap.parse_args(argv)


def result_line(cell, run, checks, traced: bool, rehearse: bool) -> dict:
    """The run's JSON object (``checks`` last)."""
    from benchmark_torch.common.harness import is_correct, load_reader

    line = {"correct": is_correct(checks), "attempted": run.window.calls, "failed": 0}
    if rehearse:
        line["metrics"] = {}
        line["device"] = {"platform": "cpu", "rehearsal": True}
    else:
        import torch

        metrics = {}
        for m in cell.per_layer if traced else cell.end_to_end:
            value = load_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        line["metrics"] = metrics
        line["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                          "count": cell.chips, "memory_peak_bytes": run.memory_peak_bytes}
        if traced:
            line["device"]["busy_s"] = run.trace.busy_s()
            line["device"]["window_s"] = run.trace.window_s
            line["breakdown"] = {"device_ops": run.trace.device_ops(),
                                 "idle_gaps": run.trace.idle_gaps()}
    line["checks"] = {name: {"value": v, "limit": lim} for name, (v, lim) in checks.items()}
    return line


def barred_modules() -> list:
    """The barred top-level names among the modules this process holds."""
    held = {name.split(".")[0] for name, mod in list(sys.modules.items()) if mod is not None}
    return sorted(held & BARRED)


def main(argv=None) -> int:
    args = parse(argv)
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(BUILD, sub)
    sys.path.insert(0, ROOT)
    from benchmark_torch.common.harness import find_cell, load_benchmark, run_cell

    cell = find_cell(load_benchmark(), args.workload, rehearse=args.rehearse)
    import torch

    if args.rehearse:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"{cell.name} needs {cell.chips} CUDA card(s); torch sees "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.set_num_threads(1)
    traced = bool(args.trace)
    run, checks = run_cell(cell, args.seed, args.seconds, traced, device, T_START)
    line = result_line(cell, run, checks, traced, args.rehearse)
    barred = barred_modules()
    if barred:
        print(f"loaded in the run's process once the window closed: {', '.join(barred)}; "
              "no result", file=sys.stderr)
        return 3
    for name, (v, lim) in checks.items():
        print(f"check {name} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
