"""PyTorch port: the motion pyramid's host path with no sync, and its replay
as one CUDA graph (``ops.motion.replays``, ``GRAPH_CALLS``).

On the CPU: the hybrid refinement's fixed seed bound gives the flows of the
bound once sized from the seed (``_quantum(_base_max(seed))``) bit for bit,
through ``_pyramid`` with the plain stages; the seed upscale's cached tap
tables equal ``_halfpixel_taps``'s and are copied once a shape; which
argument sets may replay; the benchmark's ``graph_replay_share.batch``
reader on a hand-built record. Frames of at most 2 x 48 x 64.

On the card (marker ``cuda``, skipped without one): replays equal the eager
kernel stages and the plain stages at every level, a call's flows outlive
the next replay, no replay and no admitted eager call syncs, the counter
reads eager, capture, replay, the cache keeps ``GRAPH_KEYS`` keys, and the
profiler sees the kernels a replay runs. Run there with the repository's
card command, ``python -m pytest -p no:cacheprovider -m cuda tests/``.
"""

import time

import numpy as np
import pytest
import torch

from benchmark_torch.common import program, trace
from benchmark_torch.common.harness import Run, find_cell, load_benchmark, load_reader
from benchmark_torch.common.traffic import Window
from oclcomputervision_tpu_torch.kernels import _build
from oclcomputervision_tpu_torch.kernels import motion as kmotion
from oclcomputervision_tpu_torch.ops import motion as om
from oclcomputervision_tpu_torch.utils.tracing import Span

torch.set_num_threads(2)

# the motion cell's call, as _pyramid's positional arguments after the frames
CELL = (3, 15, 5, "fixed", "fast", 9, "auto", "auto", 12, "auto")
REPLAY_SHARE = "graph_replay_share.batch"


def _pair(seed, shape, device="cpu"):
    """Noise and the same noise moved by (2, 3) px: every level's flow has
    a positive largest component, which 'shipped' seeding divides by."""
    g = torch.Generator().manual_seed(seed)
    f0 = torch.randint(0, 256, shape, dtype=torch.uint8, generator=g)
    return f0.to(device), torch.roll(f0, (2, 3), (1, 2)).to(device)


def _planted(scale, shape):
    """A non-integer seed field in [-scale, scale] whose largest |trunc| is
    trunc(scale)."""
    g = torch.Generator().manual_seed(shape[1])
    seed = (torch.rand(shape, generator=g) * 2 - 1) * scale
    seed[0, 0, 0, 0] = -scale
    return seed


@pytest.mark.parametrize("seed_mode, scale, quantum", [
    ("fixed", 5.5, 8),  # under the first quantum
    ("fixed", 13.7, 16),  # between quanta
    ("fixed", 21.2, 24),
    ("fixed", 32.6, 32),  # the largest quantum, just held
    ("fixed", 47.3, 32),  # beyond it: clamped
    ("fixed", None, None),  # the median of the fast flow: integer seeds
    ("shipped", None, None),  # the same in 'shipped' mode: non-integer seeds
])
def test_the_fixed_refinement_bound_gives_the_sized_bounds_flows(seed_mode, scale, quantum):
    """Each refinement pass (the only seeded exact search of a fast call)
    with the fixed bound against the same pass with the seed clipped to the
    bound once sized from it, and that bound."""
    passes = []

    def exact(f0, f1, search, patch, cost, seed=None, bound=None, mode="shipped"):
        got = kmotion.me_exact(f0, f1, search, patch, cost, seed, bound, mode)
        if seed is not None:
            rb = om._quantum(om._base_max(seed))
            clipped = torch.clamp(seed, -float(rb), float(rb))
            old = kmotion.me_exact(f0, f1, search, patch, cost, clipped, rb, mode)
            passes.append((bound, rb, torch.equal(got, old)))
        return got

    def median(mv, k):
        return kmotion.flow_median(mv, k) if scale is None else _planted(scale, mv.shape)

    stages = om.PLAIN_STAGES._replace(exact=exact, median=median)
    f0, f1 = _pair(3, (2, 48, 64))
    flows = om._pyramid(f0, f1, 3, 15, 5, seed_mode, "fast", 0, "auto", "auto", 0, "auto", stages)
    assert [tuple(f.shape) for f in flows] == [(2, 12, 16, 2), (2, 24, 32, 2), (2, 48, 64, 2)]
    assert len(passes) == 2 and all(same for _, _, same in passes), passes
    assert {bound for bound, _, _ in passes} == {om.SEED_BOUND_QUANTA[-1]}
    if quantum is not None:
        assert {rb for _, rb, _ in passes} == {quantum}


def test_the_tap_tables_are_the_taps_and_are_copied_once_a_shape(monkeypatch):
    om._halfpixel_table.cache_clear()
    i0, i1, u = om._halfpixel_taps(26, 13)
    got = om._halfpixel_table(26, 13, torch.device("cpu"))
    for t, want in zip(got, (i0, i1, 1 - u, u)):
        assert t.dtype == torch.from_numpy(want).dtype and np.array_equal(t.numpy(), want)
    mv = torch.randn(2, 13, 17, 2, generator=torch.Generator().manual_seed(4))
    first = om.upscale_mv(mv, 2, mode="fixed")
    copies = []
    real = torch.from_numpy
    monkeypatch.setattr(torch, "from_numpy", lambda a: copies.append(a.shape) or real(a))
    again = om.upscale_mv(mv, 2, mode="shipped")
    assert copies == [] and tuple(again.shape) == tuple(first.shape) == (2, 26, 34, 2)


CUDA = torch.device("cuda")


@pytest.mark.parametrize("device, levels, method, warp_bound, seed_bound, admitted", [
    (CUDA, 3, "fast", "auto", "auto", True),  # the motion cell's call
    (CUDA, 3, "fast", "gather", 12, True),  # no seeded exact level: seed_bound unused
    (CUDA, 3, "exact", "auto", "none", True),  # seeded exact levels with no bound
    (CUDA, 1, "exact", 4, "auto", True),  # one level: no seed
    (torch.device("cpu"), 3, "fast", "auto", "auto", False),  # CPU tensors
    (CUDA, 3, "fast", 8, "auto", False),  # an int warp_bound reads the seed back
    (CUDA, 3, "exact", "auto", "auto", False),  # seeded exact levels size their bound
    (CUDA, 2, "exact", "auto", 16, False),  # ... or warn at theirs
    (CUDA, 0, "fast", "auto", "auto", False),  # no level: nothing to capture
])
def test_which_calls_may_replay(device, levels, method, warp_bound, seed_bound, admitted):
    assert om.replays(device, levels, method, warp_bound, seed_bound) is admitted


def test_a_cpu_call_runs_eagerly_and_is_not_cached():
    f0, f1 = _pair(5, (1, 24, 32))
    before, keys = dict(om.GRAPH_CALLS), list(om._GRAPHS)
    for _ in range(2):
        om.estimate_motion_pyramid(f0, f1, 2, 7, 3, method="fast", smooth=3)
    assert om.GRAPH_CALLS == {**before, "eager": before["eager"] + 2}
    assert list(om._GRAPHS) == keys


def _span(name, call, t0, t1, parent=None):
    r = Span(name)
    r.call, r.parent, r.t0, r.t1, r.syncs = call, parent, t0, t1, []
    return r


def _replay_share(monkeypatch, record):
    window = (10.0, 10.1)
    t = trace.Trace(window, [("kernel", 10.0, 10.1)], [("window", *window)], 9.5)
    cell = find_cell(load_benchmark(), "motion_vga_hybrid.batch4")
    run = Run(cell, 3.0, Window(0.0, 0.1, 6), 4, 480 * 640, {}, frozenset(), trace=t)
    monkeypatch.setattr(program, "records", lambda: record)
    return load_reader(REPLAY_SHARE)(run)


# host times: the window is 0.5-0.6 s (profiler times less 9.5)
REPLAYED = [_span("ocv.motion", 16, 0.51, 0.52), _span("ocv.motion.replay", 16, 0.511, 0.519, 0)]
EAGER = [_span("ocv.motion", 32, 0.53, 0.55), _span("ocv.pyramid", 32, 0.531, 0.532, 2)]


@pytest.mark.parametrize("record, share", [
    (REPLAYED, 100.0),
    (REPLAYED + EAGER, 50.0),
    (EAGER, 0.0),
    ([], None),  # no sampled call
    ([_span("ocv.raisr", 16, 0.51, 0.52)], None),  # no motion call
    ([_span("ocv.motion", 0, 0.40, 0.41), _span("ocv.motion.replay", 0, 0.401, 0.409, 0)],
     None),  # a call before the window
])
def test_the_replay_share_reader(monkeypatch, record, share):
    assert _replay_share(monkeypatch, record) == share


def test_the_replay_share_reader_reads_nothing_from_a_program_that_never_replays(monkeypatch):
    monkeypatch.delattr(om, "GRAPH_CALLS")
    assert _replay_share(monkeypatch, REPLAYED) is None


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph is captured and replayed only there")
    om._GRAPHS.clear()
    yield torch.device("cuda")
    om._GRAPHS.clear()


def _calls(f0, f1, args=CELL):
    return om.estimate_motion_pyramid(f0, f1, *args)


@pytest.mark.cuda
def test_card_replays_equal_the_eager_and_plain_stages(card):
    """Calls 1-5 of one key on five pairs: eager, capture, then three
    replays, each equal at every level to the eager kernel stages and to
    the plain stages (== : the median may give a zero the other sign)."""
    for k in range(5):
        f0, f1 = _pair(10 + k, (4, 240, 320), card)
        got = _calls(f0, f1)
        for stages in (om.KERNEL_STAGES, om.PLAIN_STAGES):
            want = om._pyramid(f0, f1, *CELL, stages)
            assert len(got) == len(want) == 3
            assert all(torch.equal(a, b) for a, b in zip(got, want)), (k, stages)


@pytest.mark.cuda
def test_card_a_calls_flows_outlive_the_next_replay(card):
    pairs = [_pair(20 + k, (2, 240, 320), card) for k in range(4)]
    outs = [_calls(*p) for p in pairs]  # eager, capture, replay, replay
    copies = [[f.clone() for f in o] for o in outs]
    _calls(*pairs[0])
    torch.cuda.synchronize()
    for o, c in zip(outs, copies):
        assert all(torch.equal(a, b) for a, b in zip(o, c))
    assert not any(a.data_ptr() == b.data_ptr() for a, b in zip(outs[2], outs[3]))


@pytest.mark.cuda
def test_card_calls_count_eager_capture_replay_and_a_replay_launches_nothing(card):
    f0, f1 = _pair(30, (2, 120, 160), card)
    seen = []
    for _ in range(3):
        before, launches = dict(om.GRAPH_CALLS), sum(_build.LAUNCHES.values())
        _calls(f0, f1)
        seen.append(([k for k, v in om.GRAPH_CALLS.items() if v != before[k]],
                     sum(_build.LAUNCHES.values()) - launches))
    assert [paths for paths, _ in seen] == [["eager"], ["capture"], ["replay"]]
    assert seen[0][1] == seen[1][1] > 0 and seen[2][1] == 0


@pytest.mark.cuda
def test_card_a_replay_makes_no_sync(card):
    f0, f1 = _pair(31, (4, 480, 640), card)
    _calls(f0, f1)
    _calls(f0, f1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        flows = _calls(f0, f1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert om.GRAPH_CALLS["replay"] >= 1 and len(flows) == 3


@pytest.mark.cuda
@pytest.mark.parametrize("args", [
    CELL,
    (3, 15, 5, "fixed", "fast", 0, "gather", "auto", 0, "none"),
    (3, 15, 5, "fixed", "exact", 5, "auto", "none", 1, "auto"),
    (3, 15, 5, "fixed", "exact", 7, "auto", None, 0, "exact"),
    (1, 15, 5, "fixed", "fast", 9, 4, 8, 3, "auto"),
])
def test_card_admitted_arguments_run_eagerly_without_a_sync(card, args):
    """An eager call of each admitted argument set, its tap tables cached,
    under the card's sync debug mode "error"."""
    levels, method, warp_bound, seed_bound = args[0], args[4], args[6], args[7]
    assert om.replays(card, levels, method, warp_bound, seed_bound)
    f0, f1 = _pair(32, (2, 96, 128), card)
    om._pyramid(f0, f1, *args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        om._pyramid(f0, f1, *args)
    finally:
        torch.cuda.set_sync_debug_mode(0)


@pytest.mark.cuda
def test_card_arguments_that_sync_stay_eager(card):
    f0, f1 = _pair(33, (2, 96, 128), card)
    args = (3, 15, 5, "fixed", "fast", 9, 16, "auto", 1, "auto")  # an int warp_bound
    before = dict(om.GRAPH_CALLS)
    for _ in range(3):
        _calls(f0, f1, args)
    assert om.GRAPH_CALLS == {**before, "eager": before["eager"] + 3} and not om._GRAPHS


@pytest.mark.cuda
def test_card_the_cache_keeps_the_latest_keys(card):
    shapes = [(1, 48, 64 + 8 * k) for k in range(om.GRAPH_KEYS + 1)]
    for shape in shapes:
        _calls(*_pair(34, shape, card))
    assert len(om._GRAPHS) == om.GRAPH_KEYS
    assert [key[1] for key in om._GRAPHS] == shapes[1:]
    before = dict(om.GRAPH_CALLS)
    _calls(*_pair(34, shapes[0], card))  # evicted: a first call again
    assert om.GRAPH_CALLS["eager"] == before["eager"] + 1


@pytest.mark.cuda
def test_card_the_profiler_sees_the_kernels_a_replay_runs(card):
    from torch.profiler import ProfilerActivity, profile, record_function

    f0, f1 = _pair(35, (2, 240, 320), card)
    _calls(f0, f1)
    _calls(f0, f1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("window"):
            start = time.perf_counter()
            _calls(f0, f1)
            torch.cuda.synchronize()
    ops = trace.read_profile(prof, start).ops
    for kernel, launches in (("me_exact_kernel", 3), ("me_fast_round_kernel", 6),
                             ("subpixel_fit_kernel", 36), ("flow_median_kernel", 38)):
        assert len(trace.named(ops, kernel)) == launches, kernel
