"""PyTorch port: ``utils.tracing`` (the program's stage spans and ``syncs``
counter, in the enhance pipeline, RAISR and the motion pyramid) and
``utils.profiling.idle_share``, on the CPU."""

import time
import warnings

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark_torch.common.trace import read_profile
from oclcomputervision_tpu_torch.models import EnhanceConfig, EnhancePipeline, RaisrModel
from oclcomputervision_tpu_torch.ops import motion
from oclcomputervision_tpu_torch.utils import tracing
from oclcomputervision_tpu_torch.utils.config import RaisrConfig
from oclcomputervision_tpu_torch.utils.profiling import idle_share

STAGES = ["ocv.equalize", "ocv.raisr", "ocv.resize", "ocv.pyramid"]
RAISR_STAGES = ["ocv.raisr.in", "ocv.raisr.upscale", "ocv.raisr.hash", "ocv.raisr.apply",
                "ocv.raisr.out"]
SYNC = tracing.SYNC_WARNING + " (Triggered internally at CUDAFunctions.h:120.)"
# the hybrid motion pyramid: 3 levels, 2 subpixel rounds each
HYBRID = {"levels": 3, "method": "fast", "smooth": 9, "subpixel": 2}
ROUNDS = ["ocv.motion.subpixel", "ocv.motion.median"] * HYBRID["subpixel"]
REFINED = ["ocv.motion.fast", "ocv.motion.median", "ocv.motion.exact", *ROUNDS]
MOTION_STAGES = ["ocv.pyramid", "ocv.motion.exact", *ROUNDS, "ocv.motion.upscale", *REFINED,
                 "ocv.motion.upscale", *REFINED]


@pytest.fixture(scope="module")
def pipe():
    cfg = RaisrConfig()
    bank = torch.zeros(cfg.num_filters, cfg.filter_len, cfg.filter_len)
    return EnhancePipeline(EnhanceConfig(equalize="global", superres="raisr", resize_to=(40, 56),
                                         pyramid_depth=2), raisr_model=RaisrModel(cfg, bank))


@pytest.fixture(scope="module")
def frames():
    g = torch.Generator().manual_seed(15)
    return torch.randint(0, 256, (2, 24, 32), dtype=torch.uint8, generator=g)


@pytest.fixture(scope="module")
def pair():
    g = torch.Generator().manual_seed(18)
    return torch.randint(0, 256, (2, 2, 24, 32), dtype=torch.uint8, generator=g)


def _hybrid(pair):
    return motion.estimate_motion_pyramid(pair[:, 0], pair[:, 1], **HYBRID)


@pytest.fixture
def every_call(monkeypatch):
    """Sample every call, for the tests of a call's structure."""
    monkeypatch.setattr(tracing, "SAMPLE_EVERY", 1)


@pytest.fixture(autouse=True)
def _empty_record():
    tracing.reset()
    yield
    tracing.reset()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _children(recs, parent):
    return [r.name for r in recs if r.parent == parent]


@pytest.fixture
def fake_card(monkeypatch):
    """The process "uses the card": the sync debug mode is a variable, and
    any CUDA event, launch-side stream or allocation of a span fails."""
    state = {"mode": 0, "set": []}

    def refuse(*args, **kwargs):
        raise AssertionError("a span touched the card")

    def set_mode(mode):
        state["set"].append(mode)
        state["mode"] = {"default": 0, "warn": 1, "error": 2}.get(mode, mode)

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: state["mode"])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", set_mode)
    for name in ("Event", "current_stream", "synchronize", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    return state


def test_off_span_is_the_shared_noop(pipe, frames, monkeypatch):
    assert not torch.autograd._profiler_enabled()
    assert tracing.span("ocv.x") is tracing.span("ocv.y") is tracing._OFF

    def refuse(*args):
        raise AssertionError("a span did work with no profiler active")

    for name in ("_RANGE", "_clock", "Span"):  # no range, no clock read, no record
        monkeypatch.setattr(tracing, name, refuse)
    with torch.profiler.record_function("outside"):  # a range, but no profiler
        pipe(frames)
    assert tracing.records() == []


def test_pipeline_spans_nest_in_order(pipe, frames):
    with _cpu_profile() as prof:
        pipe(frames)
    recs = tracing.records()
    assert recs[0].name == "ocv.enhance" and recs[0].parent is None
    assert {r.call for r in recs} == {0}
    assert _children(recs, 0) == STAGES
    raisr = next(i for i, r in enumerate(recs) if r.name == "ocv.raisr")
    assert _children(recs, raisr) == RAISR_STAGES
    assert len(recs) == 1 + len(STAGES) + len(RAISR_STAGES)
    for r in recs:
        assert r.t0 <= r.t1 and r.syncs == []  # no card: no sync
        if r.parent is not None:
            p = recs[r.parent]
            assert p.t0 <= r.t0 and r.t1 <= p.t1
    names = [e.name for e in prof.events() if e.name.startswith("ocv.")]
    assert sorted(names) == sorted(r.name for r in recs)


def test_raisr_model_upsample_is_one_span_with_five_stages(pipe, frames):
    cfg = RaisrConfig()
    model = RaisrModel(cfg, torch.zeros(cfg.num_filters, cfg.filter_len, cfg.filter_len))
    with _cpu_profile():
        model.upsample(frames)
    recs = tracing.records()
    assert recs[0].name == "ocv.raisr" and recs[0].parent is None
    assert _children(recs, 0) == RAISR_STAGES and len(recs) == 6


def test_a_hybrid_motion_call_is_one_span_with_its_stages_in_order(pair):
    with _cpu_profile():
        _hybrid(pair)
    recs = tracing.records()
    assert recs[0].name == "ocv.motion" and recs[0].parent is None
    assert _children(recs, 0) == MOTION_STAGES
    assert len(recs) == 1 + len(MOTION_STAGES)  # no stage holds another
    for r in recs[1:]:
        assert recs[0].t0 <= r.t0 <= r.t1 <= recs[0].t1


def test_motion_flows_are_bit_equal_with_and_without_the_profiler(pair):
    plain = _hybrid(pair)
    with _cpu_profile():
        flows = _hybrid(pair)
    assert tracing.records()
    assert len(flows) == len(plain) == HYBRID["levels"]
    assert all(torch.equal(a, b) for a, b in zip(flows, plain))


def test_motion_syncs_land_on_the_exact_searches_and_the_upscales(pair, monkeypatch):
    """On the card a tensor read back to the host (``float``) and a numpy
    array copied to it each synchronise; here each gives the sync warning
    the card's debug mode would."""
    def syncing(fn):
        def call(*args):
            warnings.warn(SYNC)
            return fn(*args)
        return call

    monkeypatch.setattr(torch.Tensor, "__float__", syncing(torch.Tensor.__float__))
    monkeypatch.setattr(torch, "from_numpy", syncing(torch.from_numpy))
    with _cpu_profile():
        _hybrid(pair)
    syncs = {}
    for r in tracing.records():
        syncs[r.name] = syncs.get(r.name, 0) + len(r.syncs)
    # two read-backs of each refined level's bound; 8 tap uploads a seed upscale
    assert {n: k for n, k in syncs.items() if k} == {"ocv.motion.exact": 4,
                                                     "ocv.motion.upscale": 16}


def test_two_calls_get_two_call_ids_and_reset_empties(pipe, frames, every_call):
    with _cpu_profile():
        pipe(frames)
        pipe(frames[:1])
    recs = tracing.records()
    tops = [r for r in recs if r.parent is None]
    assert [(r.name, r.call) for r in tops] == [("ocv.enhance", 0), ("ocv.enhance", 1)]
    second = recs.index(tops[1])
    assert all(r.call == 0 for r in recs[:second])
    assert all(r.call == 1 for r in recs[second:])
    tracing.reset()
    assert tracing.records() == []


def test_a_span_closes_on_an_exception(fake_card, every_call):
    with _cpu_profile():
        with pytest.raises(ValueError):
            with tracing.span("ocv.a"):
                with tracing.span("ocv.b"):
                    raise ValueError("stage failed")
        assert fake_card["mode"] == 0  # back off although the call failed
        with tracing.span("ocv.c"):
            pass
    recs = tracing.records()
    assert [(r.name, r.parent, r.call, r.t1 is not None) for r in recs] == [
        ("ocv.a", None, 0, True), ("ocv.b", 0, 0, True), ("ocv.c", None, 1, True)]


def test_a_new_profiling_session_starts_a_new_record(pipe, frames, every_call):
    with _cpu_profile():
        pipe(frames)
    first = len(tracing.records())
    with _cpu_profile():
        pipe(frames)  # no span found the profiler off between: the same session
    assert len(tracing.records()) == 2 * first
    pipe(frames)  # no profiler: the record stays until the next session's first span
    assert len(tracing.records()) == 2 * first
    with _cpu_profile():
        pipe(frames)
    recs = tracing.records()
    assert len(recs) == first and {r.call for r in recs} == {0}


def test_span_times_lie_on_the_profilers_clock(pipe, frames):
    """Each span's host start and end, shifted by the benchmark's
    ``read_profile`` offset, against its profiler event."""

    def worst_error():
        tracing.reset()
        with _cpu_profile() as prof:
            with record_function("window"):
                host_start = time.perf_counter()
                pipe(frames)
        off = read_profile(prof, host_start).host_offset
        events = sorted((e for e in prof.events() if e.name.startswith("ocv.")),
                        key=lambda e: e.time_range.start)
        recs = tracing.records()
        assert [e.name for e in events] == [r.name for r in recs]
        return max(max(abs(r.t0 + off - e.time_range.start * 1e-6),
                       abs(r.t1 + off - e.time_range.end * 1e-6)) for r, e in zip(recs, events))

    worst_error()  # the first profiled range of a process can start late
    # a time slice lost to another process between the profiler's clock read
    # and the host's moves one pair by its length: take the best of 5 calls
    assert min(worst_error() for _ in range(5)) < 50e-6


def test_outputs_are_bit_equal_with_and_without_the_profiler(pipe, frames):
    plain_img, plain_levels = pipe(frames)
    with _cpu_profile():
        img, levels = pipe(frames)
    assert tracing.records()
    assert torch.equal(img, plain_img)
    assert len(levels) == len(plain_levels) == 2
    assert all(torch.equal(a, b) for a, b in zip(levels, plain_levels))


def test_syncs_count_on_the_innermost_span_with_their_host_times(recwarn):
    with _cpu_profile():
        with tracing.span("ocv.a"):
            warnings.warn(SYNC)
            with tracing.span("ocv.b"):
                t = time.perf_counter()
                warnings.warn(SYNC)
                warnings.warn(SYNC)  # "always": the same line counts again
            warnings.warn(tracing.SYNC_WARNING)
    a, b = tracing.records()
    assert (a.name, len(a.syncs), b.name, len(b.syncs), b.parent) == ("ocv.a", 2, "ocv.b", 2, 0)
    assert a.t0 <= a.syncs[0] <= b.t0 <= t <= b.syncs[0] <= b.syncs[1] <= b.t1 <= a.syncs[1] <= a.t1
    assert len(recwarn) == 0  # counted, not shown


def test_other_warnings_pass_through_untouched(recwarn):
    with _cpu_profile():
        with tracing.span("ocv.a"):
            warnings.warn("another warning", RuntimeWarning)
            warnings.warn("a warning that names no " + tracing.SYNC_WARNING)
    assert [(str(w.message), w.category) for w in recwarn] == [
        ("another warning", RuntimeWarning),
        ("a warning that names no " + tracing.SYNC_WARNING, UserWarning)]
    assert recwarn[0].filename == __file__
    assert tracing.records()[0].syncs == []


def test_the_hook_goes_in_once_per_session(pipe, frames, monkeypatch, every_call):
    starts = []
    start = tracing._Tracer.start
    monkeypatch.setattr(tracing._Tracer, "start", lambda self: (starts.append(1), start(self)))
    with _cpu_profile():
        for _ in range(3):
            pipe(frames)
            assert len(starts) == 1 and warnings.showwarning is tracing._TRACER.hook[2]
    assert len({r.call for r in tracing.records()}) == 3
    pipe(frames)  # the first span that finds the profiler off takes it out
    assert tracing._TRACER.hook is None
    with _cpu_profile():
        pipe(frames)
    assert len(starts) == 2


def test_filters_and_debug_mode_come_back_as_found(fake_card):
    before = (warnings.showwarning, list(warnings.filters))
    seen = []
    with _cpu_profile():
        for _ in range(tracing.SAMPLE_EVERY + 1):  # two sampled calls, the first and the last
            with tracing.span("ocv.a"):
                with tracing.span("ocv.b"):
                    seen.append(fake_card["mode"])
            seen.append(fake_card["mode"])
        assert warnings.showwarning is not before[0]  # the session's hook is in
    # "warn" only while a sampled call is open
    assert seen == [1, 0] + [0, 0] * (tracing.SAMPLE_EVERY - 1) + [1, 0]
    assert fake_card["set"] == ["warn", 0, "warn", 0]
    with tracing.span("ocv.c"):  # the profiler is off: the hook comes out
        pass
    assert (warnings.showwarning, list(warnings.filters)) == before
    assert fake_card["mode"] == 0 and tracing._TRACER.hook is None


def test_one_call_in_sample_every_is_traced_whole(fake_card):
    every = tracing.SAMPLE_EVERY
    with _cpu_profile() as prof:
        for _ in range(2 * every + 1):
            with tracing.span("ocv.a"):
                with tracing.span("ocv.b"):
                    if fake_card["mode"]:  # only a sampled call's syncs raise the warning
                        warnings.warn(SYNC)
    recs = tracing.records()
    assert [(r.name, r.call, len(r.syncs)) for r in recs] == [
        (n, c, int(n == "ocv.b")) for c in (0, every, 2 * every) for n in ("ocv.a", "ocv.b")]
    assert [e.name for e in prof.events() if e.name.startswith("ocv.")].count("ocv.a") == 3
    assert fake_card["set"] == ["warn", 0] * 3


def test_inside_a_call_not_sampled_every_span_is_the_noop(fake_card):
    with _cpu_profile():
        with tracing.span("ocv.a"):  # call 0, sampled
            pass
        fake_card["set"].clear()
        with tracing.span("ocv.a"):  # call 1
            assert tracing.span("ocv.b") is tracing._OFF
            with pytest.raises(RuntimeError):
                tracing.reset()
            assert fake_card["mode"] == 0
        assert isinstance(tracing.span("ocv.a"), tracing._Skip)  # call 2, opened as a call
    assert [r.call for r in tracing.records()] == [0] and fake_card["set"] == []


def test_a_debug_mode_set_by_the_caller_is_left_alone(fake_card):
    fake_card["mode"] = 2  # "error"
    with _cpu_profile():
        with tracing.span("ocv.a"):
            assert fake_card["mode"] == 2
    assert fake_card["set"] == [] and fake_card["mode"] == 2


def test_reset_inside_a_span_raises():
    with _cpu_profile():
        with tracing.span("ocv.a"):
            with pytest.raises(RuntimeError):
                tracing.reset()
    assert [r.name for r in tracing.records()] == ["ocv.a"]


@pytest.mark.parametrize("busy, window, idle", [
    ([], (0.0, 10.0), 1.0),
    ([(0.0, 10.0)], (0.0, 10.0), 0.0),
    ([(2.0, 4.0), (3.0, 5.0)], (0.0, 10.0), 0.7),  # overlaps count once
    ([(2.0, 5.0), (3.0, 4.0)], (0.0, 10.0), 0.7),  # one inside another
    ([(6.0, 8.0), (1.0, 2.0)], (0.0, 10.0), 0.7),  # unsorted; idle before, between, after
    ([(-5.0, 1.0), (9.0, 20.0)], (0.0, 10.0), 0.8),  # clipped to the window
    ([(11.0, 12.0)], (0.0, 10.0), 1.0),
])
def test_idle_share_is_the_window_left_uncovered(busy, window, idle):
    assert idle_share(busy, window) == pytest.approx(idle)
