#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from, in one process
on the card: each cell's compared numbers for the program on ``--seeds``
seeds and for the control (the plain reference one precision lower, in the
program's place) on ``--control-seeds`` seeds, each a run at the cell's own
size and load with a short window.

    python3 benchmark_torch/readings.py --workloads a,b --seeds 12 --control-seeds 3 \
        --seconds 1 [--out readings.jsonl]

Prints one JSON line per run and, per cell and number, the largest
program reading and the smallest control reading. The benchmark's own runs
never run the control.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIRST_SEED = 4_000_000_000  # program seeds count up from here, the control's from 5e9


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workloads", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out")
    ap.add_argument("--rehearse", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark_torch.common.harness import find_cell, load_benchmark, run_cell

    device = torch.device("cpu") if args.rehearse else torch.device("cuda", 0)
    if not args.rehearse and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    out = open(args.out, "a") if args.out else None
    bench = load_benchmark()
    for name in args.workloads.split(","):
        cell = find_cell(bench, name, rehearse=args.rehearse)
        worst: dict = {"program": {}, "control": {}}
        runs = [("program", FIRST_SEED + k) for k in range(args.seeds)]
        runs += [("control", 5 * 10**9 + k) for k in range(args.control_seeds)]
        for who, seed in runs:
            entry = cell.config.control(cell.spec, device) if who == "control" else None
            t0 = time.perf_counter()
            run, checks = run_cell(cell, seed, args.seconds, False, device, t0, entry=entry)
            rec = {"workload": name, "who": who, "seed": seed, "calls": run.window.calls,
                   "seconds": time.perf_counter() - t0,
                   "checks": {k: v for k, (v, _) in checks.items()}}
            print(json.dumps(rec), flush=True)
            if out:
                out.write(json.dumps(rec) + "\n")
            pick = max if who == "program" else min
            for k, (v, _) in checks.items():
                worst[who][k] = pick(worst[who].get(k, v), v)
        summary = {"workload": name, "program_max": worst["program"],
                   "control_min": worst["control"]}
        print(json.dumps(summary), flush=True)
        if out:
            out.write(json.dumps(summary) + "\n")
    print(f"readings took {time.perf_counter() - T_START:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
