"""The harness's arithmetic on the CPU: percentiles over all frames, the
rate over the window, the roofline copies against chip_smoke.py's, the
trace's intervals, and the discovery of every cell's parts by name."""

import json
import os
import re

import numpy as np
import pytest

from benchmark_torch.common import counts, readers, roofline, stats, trace
from benchmark_torch.common.harness import (BENCH_DIR, ROOT, Run, assemble, find_cell, load_benchmark,
                                             load_reader)
from benchmark_torch.common.traffic import Reservoir, Window

BENCH = load_benchmark()
# the stream mix that no cell runs yet, as a later cell would name it
STREAM = {"name": "enhance_720p.stream60", "config": "enhance_720p", "traffic": "stream_720p60",
          "chips": 1}
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


@pytest.mark.parametrize("n", [1, 2, 7, 600, 1001])
def test_percentile_is_numpys_linear_over_every_value(n):
    xs = np.random.default_rng(n).exponential(2.0, n).tolist()
    for q in (0, 50, 95, 100):
        assert stats.percentile(xs, q) == pytest.approx(np.percentile(xs, q), rel=1e-12)


def _run(calls=10, frames_per_call=16, px=2048 * 2048, frames=(), tr=None, cell=None):
    w = Window(0.0, 2.5, calls, list(frames))
    cell = cell or find_cell(BENCH, "raisr_x2.batch16")
    cnt = cell.config.counts(cell.spec, max(cell.mix["batch"], 1), cell.mix["frame"])
    return Run(cell, 3.0, w, frames_per_call, px, cnt,
               frozenset({"raisr_apply_kernel", "raisr_hash_kernel"}), trace=tr)


def test_rate_is_every_output_over_the_whole_window():
    run = _run()
    assert load_reader("out_mp_per_s")(run) == pytest.approx(10 * 16 * 2048 * 2048 / 1e6 / 2.5)
    assert load_reader("setup_s")(run) == 3.0


def test_frame_latency_is_a_percentile_of_every_frame_from_its_due_time():
    frames = [(k / 60, k / 60 + 1e-4, k / 60 + 2e-4, k / 60 + 3e-4, k / 60 + 1e-3 * (1 + k % 7))
              for k in range(600)]
    run = _run(calls=600, frames_per_call=1, frames=frames, cell=assemble(BENCH, STREAM))
    lat = [(d - u) * 1e3 for u, _, _, _, d in frames]
    assert load_reader("frame_p95_ms")(run) == pytest.approx(np.percentile(lat, 95))
    assert readers.frame_latency_ms(run, 50) == pytest.approx(np.percentile(lat, 50))
    assert load_reader("out_mp_per_s")(run) is None  # a stream reports no batch rate
    assert load_reader("launches_per_frame.stream")(run) is None  # nothing traced


def test_open_loop_bursts_keep_the_mean_rate():
    from benchmark_torch.loops.open import due_times

    steady, bursty = due_times(10.0, 0.1, 1), due_times(10.0, 0.1, 4)
    assert [steady(i) for i in range(3)] == pytest.approx([10.0, 10.1, 10.2])
    assert [bursty(i) for i in range(9)] == pytest.approx([10.0] * 4 + [10.4] * 4 + [10.8])


def test_roofline_copies_equal_chip_smokes():
    import chip_smoke

    assert roofline.OPS_PER_ELEM == chip_smoke.OPS_PER_ELEM
    assert (roofline.HBM_BYTES_PER_S, roofline.F32_OPS_PER_S) == (
        chip_smoke.HBM_BYTES_PER_S, chip_smoke.F32_OPS_PER_S)
    for name, moved, elems in (("raisr_apply", 10**9, 10**8), ("raisr_hash", 10**6, 10**9)):
        ms, _ = chip_smoke.bound(name, moved, elems)
        ops = roofline.OPS_PER_ELEM[name] * elems
        assert roofline.least_seconds(moved, ops) == pytest.approx(ms / 1e3, rel=1e-12)

    class Cfg:
        gauss_len, strength_quantizers, coherence_quantizers = 7, (1, 2, 3, 4, 5), (1, 2)

    assert roofline.hash_ops(7, 5, 2) == chip_smoke.hash_ops(Cfg)


@pytest.mark.parametrize("hw", [(1024, 1024), (720, 1280), (480, 640)])
def test_raisr_counts_equal_chip_smokes_tensors(hw):
    """Phase 6's bytes (nbytes of the kernels' tensors) and, where the
    planes are not padded, its elements."""
    import torch

    from oclcomputervision_tpu_torch.ops.raisr import plane_geometry
    from oclcomputervision_tpu_torch.utils.config import RaisrConfig

    spec = json.load(open(os.path.join(BENCH_DIR, "configs", "raisr_x2.json")))
    r, b = spec["raisr"], 16
    geo = plane_geometry(*hw, RaisrConfig())
    assert counts.plane_geometry(*hw, r) == (geo.h2p, geo.w2p, geo.hp, geo.hq, geo.wq)
    f32 = lambda *s: int(np.prod(s)) * 4
    up, hb = f32(b, 4, geo.hq, geo.wq), f32(b, 4, geo.h2p, geo.w2p)
    k = counts.raisr_stages(r, b, *hw)
    assert k["raisr_hash"][0] == up + hb
    assert k["raisr_apply"][0] == up + hb + f32(864, 11, 11) + hb
    if (geo.h2p, geo.w2p) == hw:
        assert k["raisr_hash"][1] == 150 * b * 4 * geo.h2p * geo.w2p
        assert k["raisr_apply"][1] == 242 * b * 4 * geo.h2p * geo.w2p


def test_enhance_counts_add_the_stages():
    cell = find_cell(BENCH, "enhance_720p.batch16")
    c = cell.config.counts(cell.spec, 16, (720, 1280))
    raisr = counts.raisr_call(cell.spec["raisr"], 16, 720, 1280)
    assert c["call"][1] > raisr[1]
    assert c["call"][0] == 16 * (720 * 1280 + 1080 * 1920 + 540 * 960 + 270 * 480) + 864 * 121 * 4


def test_intervals():
    u = trace.union([(3, 4), (0, 1), (0.5, 2), (4, 5)])
    assert u == [(0, 2), (3, 5)]
    assert trace.gaps(u, (-1, 6)) == [(-1, 0), (2, 3), (5, 6)]
    assert trace.overlap(u, 1.5, 3.5) == pytest.approx(1.0)


def test_trace_readers():
    t = trace.Trace((0.0, 1.0), [("void ns::raisr_apply_kernel<2>(float*)", 0.1, 0.3),
                                 ("raisr_apply_generic_kernel", 0.3, 0.35),
                                 ("elementwise_kernel", 0.35, 0.4),
                                 ("Memcpy HtoD", 0.5, 0.6)],
                    [("window", 0.0, 1.0), ("entry", 0.0, 0.42), ("wait", 0.42, 1.0)], 0.0)
    assert trace.named(t.ops, "raisr_apply_kernel") == t.ops[:1]
    assert len(t.kernels()) == 3
    assert t.busy_s() == pytest.approx(0.4)
    assert dict((n, s) for n, s in t.idle_gaps()) == pytest.approx({"entry": 0.1, "wait": 0.5})
    run = _run(calls=2, tr=t)
    assert load_reader("device_idle.batch")(run) == pytest.approx(60.0)
    own = run.own_kernels
    assert load_reader("glue_ms.batch")(run) == pytest.approx(1e3 * 0.1 / 2)  # generic and aten
    assert own == {"raisr_apply_kernel", "raisr_hash_kernel"}
    least = roofline.least_seconds(*run.counts["kernels"]["raisr_apply"])
    assert load_reader("raisr_apply_roofline")(run) == pytest.approx(100 * least * 2 / 0.2)
    assert load_reader("raisr_hash_roofline")(run) is None  # nothing to read


def test_reservoir_keeps_k_uniformly_and_repeats_with_the_seed():
    picks = []
    for seed in (1, 1, 2):
        r = Reservoir(4, seed)
        for i in range(1000):
            r.offer(i)
        picks.append(sorted(r.items))
    assert picks[0] == picks[1] != picks[2] and len(picks[0]) == 4


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_is_found_by_its_names(cell):
    c = find_cell(BENCH, cell)
    for m in c.end_to_end + c.per_layer:
        assert callable(load_reader(m["name"]))
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"} and len(c.end_to_end) >= 2
    assert c.per_layer
    assert set(c.spec["limits"]) and all(v is not None for v in c.spec["limits"].values())


def test_benchmark_json_keeps_to_its_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [m["name"] for m in METRICS]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
    for m in METRICS:
        assert set(m) - {"workloads"} <= {"name", "unit", "better", "bound", "source", "layer",
                                          "moves"}
        assert all(w in CELLS for w in m.get("workloads", CELLS))
    for m in BENCH["per_layer"]:
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", CELLS))
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024
