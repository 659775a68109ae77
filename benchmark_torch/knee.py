#!/usr/bin/env python3
"""The knee of a stream: the frames of an open-loop traffic mix sent back to
back (each as soon as the one before it is done) through a configuration,
for ``--seconds``. The mix need not be one of ``BENCHMARK.json``'s cells.

    python3 benchmark_torch/knee.py --config enhance_720p --traffic stream_720p60 \
        --seconds 5 --seed <n>

Prints the frames per second sustained and the latency percentiles.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark_torch.common.harness import assemble, load_benchmark, run_cell
    from benchmark_torch.common.stats import percentile

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    name = f"{args.config}.{args.traffic}"
    cell = assemble(load_benchmark(), {"name": name, "config": args.config,
                                       "traffic": args.traffic, "chips": 1})
    if cell.mix["loop"] != "open":
        raise SystemExit(f"{args.traffic} is not an open-loop mix")
    run, _ = run_cell(cell, args.seed, args.seconds, False, torch.device("cuda", 0), T_START,
                      rate_hz=0)
    lat = [(done - due) * 1e3 for due, _, _, _, done in run.window.frames]
    print(json.dumps({"workload": name, "frames": len(lat),
                      "fps": len(lat) / run.window.seconds,
                      "p50_ms": percentile(lat, 50), "p95_ms": percentile(lat, 95)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
