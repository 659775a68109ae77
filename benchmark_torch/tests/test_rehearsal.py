"""The harness's control flow on the CPU at the rehearsal sizes: a sound
run comes out correct; the control (the plain reference one precision
lower, in the program's place) and each fault a cell can have, planted
under the timed path, come out not correct; and without a card, without
the program, or with JAX or the JAX package loaded by the time the window
has closed, a run exits non-zero and prints no result."""

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
from benchmark_torch.tests.faults import FAULTS

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


# a stream sends one frame a call: it has no batch to halve
CASES = [(c, f) for c in CELLS for f in sorted(FAULTS)
         if f != "half_left_out" or _cell(c, rehearse=False).mix["batch"] > 1]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_fault_under_the_timed_path_is_not_correct(cell, fault, monkeypatch):
    # the configuration names its own fault site; one without it fails here
    _cell(cell).config.plant(monkeypatch, FAULTS[fault]())
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


JAX_PROBE = textwrap.dedent("""
    import sys, types
    import pytest
    sys.path.insert(0, sys.argv[1])
    from benchmark_torch import run
    from benchmark_torch.common.harness import find_cell, load_benchmark

    def load(out):  # the program loads a module inside the window
        sys.modules.setdefault(sys.argv[3], types.ModuleType(sys.argv[3]))
        return out

    with pytest.MonkeyPatch.context() as mp:
        find_cell(load_benchmark(), sys.argv[2], rehearse=True).config.plant(mp, load)
        sys.exit(run.main(["--workload", sys.argv[2], "--seed", "5", "--seconds", "0.3",
                           "--trace", "0", "--rehearse"]))
""")


@pytest.mark.parametrize("module,barred", [("jax", True), ("jaxlib.xla_client", True),
                                           ("flax", True), ("oclcomputervision_tpu.ops", True),
                                           ("jaxtyping", False)])
def test_jax_held_once_the_window_closes_leaves_no_result(module, barred):
    # whole top-level names: the port's own name begins with the JAX package's
    res = subprocess.run([sys.executable, "-c", JAX_PROBE, ROOT, FIRST, module], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    if barred:
        assert res.returncode != 0 and res.stdout.strip() == "", res.stdout[-2000:]
        assert module.split(".")[0] in res.stderr.strip().splitlines()[-1]
    else:
        assert res.returncode == 0, res.stderr[-2000:]
        assert json.loads(res.stdout.strip().splitlines()[-1])["correct"] is True


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


def _harness_with(tmp_path, files: dict, bench: dict) -> dict:
    """A copy of the harness in ``tmp_path`` with ``files`` ({path under
    benchmark_torch/: text}) added and ``bench`` as its BENCHMARK.json,
    checked to change no file that was there; the environment that runs it
    (the program, beside the copied harness)."""
    shutil.copytree(os.path.join(ROOT, "benchmark_torch"), tmp_path / "benchmark_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path / "benchmark_torch")
    for rel, text in files.items():
        (tmp_path / "benchmark_torch" / rel).write_text(text)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digests(tmp_path / "benchmark_torch")
    assert set(files) <= set(after) - set(before)  # every file added is new
    assert {k: after[k] for k in before} == before  # no file that was there changed
    return {**os.environ, "PYTHONPATH": ROOT}


def test_a_loop_a_mix_and_a_metric_are_added_as_new_files(tmp_path):
    bench = dict(BENCH)
    files = {"loops/each_once.py": LOOP, "metrics/peak_mem_gb.py": READER}
    files.update({f"traffic/{name}.json": json.dumps(mix) for name, mix in MIXES.items()})
    added = [{"name": f"raisr_x2.{m}", "config": "raisr_x2", "traffic": m, "chips": 1,
              "why": "a later change's cell"} for m in MIXES]
    bench["workloads"] = BENCH["workloads"] + added
    cells = [w["name"] for w in added]
    bench["end_to_end"] = [{**m, "workloads": m["workloads"] + cells} if "workloads" in m else m
                           for m in BENCH["end_to_end"]]
    bench["per_layer"] = BENCH["per_layer"] + [
        {"name": "peak_mem_gb", "unit": "GB", "better": "lower", "source": "program_counter",
         "layer": "device", "moves": "out_mp_per_s", "workloads": cells}]
    env = _harness_with(tmp_path, files, bench)
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


# what a later change adds for a configuration whose items are frame pairs
# and whose output is a float flow: the port's one-level exact search
# against a plain SAD search, its own control and fault site, and two mixes
# of the Middlebury pairs, which exist at 480 x 640 alone (a 7 / 3 search
# keeps the rehearsal short at that size)
PAIR_CONFIG = """
import torch
import torch.nn.functional as F


def build(spec, device):
    from oclcomputervision_tpu_torch import ops

    def entry(x):  # [B, 2, H, W], or one pair [2, H, W]
        return ops.estimate_motion_vector(x[..., 0, :, :], x[..., 1, :, :],
                                          spec["search_size"], spec["patch_size"])
    return entry


def flatten(out):
    return [out]


def _search(spec, f):
    # dense block matching of f[:, 0] against f[:, 1]: zero-padded patches,
    # steps halving from search // 2 - patch // 2, the first least SAD in
    # row-major (dy, dx) order; [B, H, W, 2] (dx, dy)
    p, steps, st = spec["patch_size"], [], spec["search_size"] // 2 - spec["patch_size"] // 2
    while st >= 1:
        steps, st = steps + [st], st // 2
    b, _, h, w = f.shape
    pm, reach = p // 2, p // 2 + sum(steps)
    f0, f1 = F.pad(f[:, 0], (pm,) * 4), F.pad(f[:, 1], (reach,) * 4)
    n, ys, xs = (torch.arange(k, device=f.device) for k in (b, h, w))
    n, ys, o = n[:, None, None], ys[:, None], reach - pm
    dy = dx = torch.zeros((b, h, w), dtype=torch.long, device=f.device)
    for st in steps:
        costs = [sum((f0[n, ys + i, xs + j] - f1[n, ys + dy + oy + i + o, xs + dx + ox + j + o]).abs()
                     for i in range(p) for j in range(p))
                 for oy in (-st, 0, st) for ox in (-st, 0, st)]
        k = torch.stack(costs).argmin(0)  # the first least
        dy, dx = dy + (k // 3 - 1) * st, dx + (k % 3 - 1) * st
    return torch.stack([dx, dy], -1).to(torch.float32)


def reference(spec, x):
    return [_search(spec, x.to(torch.int32))]


def control(spec, device):
    # the search on float16 planes in [0, 1], in the program's place
    return lambda x: _search(spec, x.to(torch.float16) / 255)


def plant(monkeypatch, broken):
    from oclcomputervision_tpu_torch import ops

    search = ops.estimate_motion_vector
    monkeypatch.setattr(ops, "estimate_motion_vector", lambda *a, **k: broken(search(*a, **k)))


def out_pixels(spec, frame_hw):
    return frame_hw[0] * frame_hw[1]


def counts(spec, batch, frame_hw):
    return {}


def compare(spec, program, reference):
    p, r = program[0].to(reference[0].device), reference[0]
    if p.shape != r.shape or p.dtype != r.dtype:
        return {"flow_off_share": 1.0}
    return {"flow_off_share": (p != r).any(-1).to(torch.float64).mean().item()}
"""
PAIR_SPEC = {"name": "motion_pairs", "search_size": 7, "patch_size": 3,
             "limits": {"flow_off_share": 0.0}}
PAIR_ITEM = 2 * 480 * 640  # bytes of one pair
PAIR_MIXES = {
    # 8 calls of 2 pairs by both planes (16 by one): every window call after
    # the first reads another pool entry than the first warm-up call did
    "pairs_batch2": {"loop": "closed", "content": "middlebury_pairs", "frame": [480, 640],
                     "batch": 2, "io": "device", "pool_bytes": 8 * 2 * PAIR_ITEM,
                     "warmup": 1, "sample": 2},
    "pairs_one": {"loop": "closed", "content": "middlebury_pairs", "frame": [480, 640],
                  "batch": 0, "io": "host", "pool_frames": 3, "warmup": 1, "sample": 2},
}
PAIR_PROBE = textwrap.dedent("""
    import json, sys
    import pytest
    import torch
    sys.path.insert(0, sys.argv[1])
    from benchmark_torch.common import harness
    from benchmark_torch.common.traffic import make_inputs
    from benchmark_torch.tests.faults import FAULTS

    cpu, bench, seed = torch.device("cpu"), harness.load_benchmark(), int(sys.argv[2])

    def run(name, control=False, fault=None):
        cell = harness.find_cell(bench, name, rehearse=True)
        entry = cell.config.control(cell.spec, cpu) if control else None
        with pytest.MonkeyPatch.context() as mp:
            if fault:
                cell.config.plant(mp, FAULTS[fault]())
            run, checks = harness.run_cell(cell, seed, 2.5, False, cpu, 0.0, entry=entry)
        return {"calls": run.window.calls, "correct": harness.is_correct(checks),
                "checks": {k: v for k, (v, _) in checks.items()}}

    pool = make_inputs(harness.find_cell(bench, "motion_pairs.pairs_batch2").mix, seed, cpu)
    out = {"pool": [len(pool), list(pool[0].shape)], "sound": run("motion_pairs.pairs_batch2"),
           "one": run("motion_pairs.pairs_one"),
           "control": run("motion_pairs.pairs_batch2", control=True)}
    out.update({f: run("motion_pairs.pairs_batch2", fault=f) for f in sorted(FAULTS)})
    print(json.dumps(out))
""")


def test_a_pair_input_float_output_configuration_is_added_as_new_files(tmp_path):
    bench = dict(BENCH)
    files = {"configs/motion_pairs.py": PAIR_CONFIG,
             "configs/motion_pairs.json": json.dumps(PAIR_SPEC)}
    files.update({f"traffic/{name}.json": json.dumps(mix) for name, mix in PAIR_MIXES.items()})
    bench["configs"] = BENCH["configs"] + [
        {"name": "motion_pairs", "source": "https://vision.middlebury.edu/flow/",
         "file": "benchmark_torch/configs/motion_pairs.json", "reduced": [],
         "why": "a later change's configuration"}]
    bench["workloads"] = BENCH["workloads"] + [
        {"name": f"motion_pairs.{m}", "config": "motion_pairs", "traffic": m, "chips": 1,
         "why": "a later change's cell"} for m in PAIR_MIXES]
    env = _harness_with(tmp_path, files, bench)
    res = subprocess.run([sys.executable, "-c", PAIR_PROBE, str(tmp_path), str(SEED)],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["pool"] == [8, [2, 2, 480, 640]]  # the pool sized by both planes
    assert got["sound"]["correct"] and got["sound"]["checks"] == {"flow_off_share": 0.0}
    assert got["one"]["correct"]  # one pair a call: the mix, not the rank, says so
    for case in ["control", *FAULTS]:
        assert not got[case]["correct"], (case, got[case])
    for case in ["sound", "control", *FAULTS]:
        assert 2 <= got[case]["calls"] <= 8, (case, got[case])  # a stale call can show
    line = subprocess.run([sys.executable, "benchmark_torch/run.py", "--workload",
                           "motion_pairs.pairs_batch2", "--seed", str(SEED), "--seconds", "2.5",
                           "--trace", "0", "--rehearse"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert line.returncode == 0, line.stderr[-2000:]
    result = json.loads(line.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and list(result["checks"]) == ["flow_off_share"]
