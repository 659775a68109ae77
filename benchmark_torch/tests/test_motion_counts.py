"""``motion_vga_hybrid``'s counts on the CPU: each kernel's bytes and
operations per call equal ``chip_smoke.py``'s motion bounds (phase 6) summed
over the call's launches, the launch schedule is the program's, and each
kernel's roofline reader reads that kernel alone."""

import pytest
import torch

from benchmark_torch.common import roofline, trace
from benchmark_torch.common.harness import Run, find_cell, load_benchmark, load_reader
from benchmark_torch.common.traffic import Window

CELL = find_cell(load_benchmark(), "motion_vga_hybrid.batch4")
CONFIG, SPEC = CELL.config, CELL.spec
BATCH, FRAME = CELL.mix["batch"], tuple(CELL.mix["frame"])
KERNELS = ("me_exact", "me_fast_round", "me_fast_median")


def _meta(*shape, dtype=torch.uint8):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_the_kernel_counts_are_chip_smokes_bounds_over_the_calls_launches():
    import chip_smoke

    n = len(CONFIG.ref_motion.steps(SPEC["search_size"], SPEC["patch_size"]))
    want = {k: [0, 0] for k in KERNELS}
    for lv, (h, w) in enumerate(CONFIG.level_shapes(SPEC, FRAME)):
        b0, b1 = _meta(BATCH, h, w), _meta(BATCH, h, w)
        flow = _meta(BATCH, h, w, 2, dtype=torch.float32)
        px = b0.numel()
        seeded = (flow,) if lv else ()  # the levels after the coarsest are seeded
        parts = {"me_exact": (chip_smoke.nbytes(b0, b1, *seeded, flow), px)}
        if lv:
            parts["me_fast_round"] = (n * chip_smoke.nbytes(b0, b1) + (2 * n - 1) * 8 * px, n * px)
            parts["me_fast_median"] = (2 * n * 8 * px, n * px)
        for name, (moved, elems) in parts.items():
            want[name][0] += moved
            want[name][1] += chip_smoke.OPS_PER_ELEM[name] * elems
            ms, _ = chip_smoke.bound(name, moved, elems)
            assert roofline.least_seconds(moved, roofline.OPS_PER_ELEM[name] * elems) == (
                pytest.approx(ms / 1e3, rel=1e-12))
    got = CONFIG.counts(SPEC, BATCH, FRAME)
    assert got["kernels"] == {k: tuple(v) for k, v in want.items()}
    assert CONFIG.kernel_counts(SPEC, BATCH, FRAME) == got["kernels"]
    moved, ops = got["call"]
    assert moved == BATCH * (2 * 480 * 640 + 8 * (480 * 640 + 240 * 320 + 120 * 160))
    assert ops > sum(o for _, o in got["kernels"].values())


def test_the_launch_schedule_is_the_programs(monkeypatch):
    """The program at the cell's schedule on a small pair, its kernel
    wrappers' plain versions counted: one launch per exact search, one
    round and one median launch per step of each fast iteration."""
    from oclcomputervision_tpu_torch.kernels import motion as km

    calls = {"exact": 0, "fast": 0}

    def counting(name, fn):
        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(km, "me_exact", counting("exact", km.me_exact))
    monkeypatch.setattr(km, "me_fast", counting("fast", km.me_fast))
    x = torch.randint(0, 256, (1, 2, 48, 64), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(18))
    CONFIG.build(SPEC, torch.device("cpu"))(x)
    n = len(km.me_steps(SPEC["search_size"], SPEC["patch_size"]))
    seen = {"me_exact": calls["exact"], "me_fast_round": n * calls["fast"],
            "me_fast_median": n * calls["fast"]}
    assert seen == {"me_exact": 3, "me_fast_round": 6, "me_fast_median": 6}


@pytest.mark.parametrize("kernel", KERNELS)
def test_each_roofline_reader_reads_its_kernel_alone(kernel):
    ops = [(f"void {k}_kernel(const unsigned char*)", 0.1 * i, 0.1 * i + 0.01 * (i + 1))
           for i, k in enumerate(KERNELS)]
    t = trace.Trace((0.0, 1.0), ops + [("elementwise_kernel", 0.5, 0.6)], [("window", 0.0, 1.0)],
                    0.0)
    counts = CONFIG.counts(SPEC, BATCH, FRAME)
    run = Run(CELL, 3.0, Window(0.0, 1.0, 2), BATCH, 480 * 640, counts,
              frozenset(f"{k}_kernel" for k in KERNELS), trace=t)
    i = KERNELS.index(kernel)
    least = roofline.least_seconds(*counts["kernels"][kernel])
    assert load_reader(f"{kernel}_roofline")(run) == pytest.approx(100 * least * 2 / (0.01 * (i + 1)))
    run.trace = trace.Trace((0.0, 1.0), ops[:i] + ops[i + 1:], [("window", 0.0, 1.0)], 0.0)
    assert load_reader(f"{kernel}_roofline")(run) is None  # nothing of it to read
