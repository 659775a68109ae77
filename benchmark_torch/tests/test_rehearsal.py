"""The harness's control flow on the CPU at the rehearsal sizes: a sound
run comes out correct; the control (the plain reference one precision
lower, in the program's place) and each fault a cell can have, planted
under the timed path, come out not correct; and without a card, or
without the program, a run exits non-zero and prints no result."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

from benchmark_torch.common.harness import ROOT, assemble, is_correct, load_benchmark, run_cell
from oclcomputervision_tpu_torch.models import EnhancePipeline, RaisrModel

BENCH = load_benchmark()
# the cells, and the stream mix (open loop, host io) that no cell runs yet
WORKLOADS = {w["name"]: w for w in BENCH["workloads"]}
WORKLOADS["enhance_720p.stream60"] = {"name": "enhance_720p.stream60", "config": "enhance_720p",
                                      "traffic": "stream_720p60", "chips": 1}
CELLS = sorted(WORKLOADS)
FIRST = BENCH["workloads"][0]["name"]
CPU = torch.device("cpu")
SEED = 3_141_592_653  # more than 32 signed bits hold


def _cell(name, rehearse=True):
    return assemble(BENCH, WORKLOADS[name], rehearse=rehearse)


def _run(cell_name, entry=None, seed=SEED, seconds=0.3):
    return run_cell(_cell(cell_name), seed, seconds, False, CPU, 0.0, entry=entry)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    # a rehearsal call takes up to about 0.9 s on a loaded CPU
    run, checks = _run(cell, seconds=1.0)
    assert run.window.calls >= 2
    assert is_correct(checks), checks


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    c = _cell(cell)
    _, checks = _run(cell, entry=c.config.control(c.spec, CPU))
    assert not is_correct(checks), checks


def _altered(out):
    """An answer altered where it is produced: every pixel three levels up."""
    return torch.clamp(out.to(torch.int16) + 3, 0, 255).to(torch.uint8)


def _half_left_out(out):
    """Half of the batch left out: its second half a copy of the first."""
    if out.ndim < 3:
        return out
    out = out.clone()
    n = out.shape[0] // 2
    out[out.shape[0] - n:] = out[:n]
    return out


class _Stale:
    """A step that returns its state unchanged: every call after the first
    hands back the first call's result."""

    def __init__(self):
        self.first = None

    def __call__(self, out):
        if self.first is None or self.first.shape != out.shape:
            self.first = out
        return self.first


FAULTS = {"altered": lambda: _altered, "half_left_out": lambda: _half_left_out,
          "stale": _Stale}
# a stream sends one frame a call: it has no batch to halve
CASES = [(c, f) for c in CELLS for f in sorted(FAULTS)
         if f != "half_left_out" or _cell(c, rehearse=False).mix["batch"] > 1]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_fault_under_the_timed_path_is_not_correct(cell, fault, monkeypatch):
    broken = FAULTS[fault]()
    upsample, call = RaisrModel.upsample, EnhancePipeline.__call__
    if cell.startswith("raisr_x2"):
        monkeypatch.setattr(RaisrModel, "upsample", lambda self, x: broken(upsample(self, x)))
    else:
        def pipeline(self, x, **kw):
            image, levels = call(self, x, **kw)
            image = broken(image)
            return image, [*levels[:-1], image]
        monkeypatch.setattr(EnhancePipeline, "__call__", pipeline)
    _, checks = _run(cell)
    assert not is_correct(checks), checks


def _command(args, cwd):
    return subprocess.run([sys.executable, "benchmark_torch/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_without_a_card_a_run_exits_non_zero_with_no_result():
    res = _command(["--workload", FIRST, "--seed", "1", "--seconds", "1", "--trace", "0"], ROOT)
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_the_rehearsal_line_holds_no_metric():
    res = _command(["--workload", FIRST, "--seed", str(SEED), "--seconds", "0.3",
                    "--trace", "1", "--rehearse"], ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["metrics"] == {} and line["device"]["platform"] == "cpu"
    assert list(line)[-1] == "checks" and line["correct"] is True
    assert res.stderr.strip().splitlines()[-1].startswith("check off_gt1_share")


def test_alone_in_a_directory_a_run_exits_non_zero_with_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark_torch"), tmp_path / "benchmark_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = _command(["--workload", FIRST, "--seed", "1", "--seconds", "1", "--trace", "0",
                    "--rehearse"], tmp_path)
    assert res.returncode != 0 and res.stdout.strip() == ""


# what a later change adds: a driver of its own, a mix that names it, a
# mix that only sets data (a closed loop over host memory) and a metric
LOOP = """
from benchmark_torch.common.traffic import Reservoir, Window, sync, to_card, to_host
import time


def run(entry, flatten, pool, mix, seconds, seed, device, spans):
    keep, t0 = Reservoir(mix["sample"], seed), time.perf_counter()
    for i, x in enumerate(pool):
        keep.offer((i, i, to_host(flatten(entry(to_card(x, mix, device, spans))), mix, spans)))
    sync(device)
    return Window(t0, time.perf_counter(), len(pool), kept=keep.items)
"""
MIXES = {
    "each_once": {"loop": "each_once", "frame": [40, 56], "batch": 3, "io": "device",
                  "pool_frames": 9, "warmup": 1, "sample": 2},
    "host_batch": {"loop": "closed", "frame": [40, 56], "batch": 3, "in_flight": 2, "io": "host",
                   "pool_frames": 9, "warmup": 1, "sample": 2},
}
READER = "def read(run):\n    return None if run.memory_peak_bytes is None else run.memory_peak_bytes / 1e9\n"
PROBE = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    sys.path.insert(0, sys.argv[1])
    from benchmark_torch.common import harness
    check, seen = harness.check, []

    def kept_check(cell, kept, device):  # what the window's calls handed back
        seen[:] = [isinstance(outs[0], np.ndarray) for _, outs in kept]
        return check(cell, kept, device)

    harness.check = kept_check
    out = {}
    for name in ("raisr_x2.each_once", "raisr_x2.host_batch"):
        cell = harness.find_cell(harness.load_benchmark(), name, rehearse=True)
        run, checks = harness.run_cell(cell, 7, 0.2, False, torch.device("cpu"), 0.0)
        out[name] = {"calls": run.window.calls, "checks": {k: v for k, (v, _) in checks.items()},
                     "host": list(seen),
                     "metrics": [m["name"] for m in cell.per_layer],
                     "peak": harness.load_reader("peak_mem_gb")(run)}
    print(json.dumps(out))
""")


def _digests(root):
    return {os.path.relpath(os.path.join(d, f), root):
            hashlib.sha256(open(os.path.join(d, f), "rb").read()).hexdigest()
            for d, _, fs in os.walk(root) for f in fs if "__pycache__" not in d}


def test_a_loop_a_mix_and_a_metric_are_added_as_new_files(tmp_path):
    shutil.copytree(os.path.join(ROOT, "benchmark_torch"), tmp_path / "benchmark_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path / "benchmark_torch")
    bench = dict(BENCH)
    (tmp_path / "benchmark_torch" / "loops" / "each_once.py").write_text(LOOP)
    for name, mix in MIXES.items():
        (tmp_path / "benchmark_torch" / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    (tmp_path / "benchmark_torch" / "metrics" / "peak_mem_gb.py").write_text(READER)
    added = [{"name": f"raisr_x2.{m}", "config": "raisr_x2", "traffic": m, "chips": 1,
              "why": "a later change's cell"} for m in MIXES]
    bench["workloads"] = BENCH["workloads"] + added
    cells = [w["name"] for w in added]
    bench["end_to_end"] = [{**m, "workloads": m["workloads"] + cells} if "workloads" in m else m
                           for m in BENCH["end_to_end"]]
    bench["per_layer"] = BENCH["per_layer"] + [
        {"name": "peak_mem_gb", "unit": "GB", "better": "lower", "source": "program_counter",
         "layer": "device", "moves": "out_mp_per_s", "workloads": cells}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digests(tmp_path / "benchmark_torch")
    assert {k: after[k] for k in before} == before  # no file that was there changed
    env = {**os.environ, "PYTHONPATH": ROOT}  # the program, beside the copied harness
    res = subprocess.run([sys.executable, "-c", PROBE, str(tmp_path)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["raisr_x2.each_once"]["calls"] == 3  # 9 frames, 3 a call, each once
    assert got["raisr_x2.each_once"]["host"] == [False, False]
    assert got["raisr_x2.host_batch"]["host"] == [True, True]  # outputs back in host memory
    for name in cells:
        assert got[name]["checks"]["off_gt1_share"] < 0.01
        assert "peak_mem_gb" in got[name]["metrics"] and got[name]["peak"] is None  # the CPU
        line = subprocess.run([sys.executable, "benchmark_torch/run.py", "--workload", name,
                               "--seed", str(SEED), "--seconds", "0.2", "--trace", "0",
                               "--rehearse"], cwd=tmp_path, env=env, capture_output=True,
                              text=True, timeout=300)
        assert line.returncode == 0, line.stderr[-2000:]
        assert json.loads(line.stdout.strip().splitlines()[-1])["correct"] is True
