"""The readers of the program's own spans and ``syncs`` counter
(``common/program.py``, ``host_syncs_per_call.batch``,
``sync_idle_ms.batch``) on a hand-built trace and record, on the CPU."""

import pytest

from benchmark_torch.common import program, trace
from benchmark_torch.common.harness import Run, find_cell, load_benchmark, load_reader
from benchmark_torch.common.traffic import Window
from oclcomputervision_tpu_torch.utils.tracing import Span

OFFSET = 9.5  # profiler seconds minus host seconds
SYNCS, IDLE = "host_syncs_per_call.batch", "sync_idle_ms.batch"
COPY = "Memcpy HtoD (Pageable -> Device)"


def _span(name, call, t0, t1, parent=None, syncs=()):
    r = Span(name)
    r.call, r.parent, r.t0, r.t1, r.syncs = call, parent, t0, t1, list(syncs)
    return r


def _run(ops, calls=4, window=(10.0, 10.1)):
    """A run whose traced window holds the device operations ``ops``
    ((name, start, end), profiler seconds)."""
    t = trace.Trace(window, list(ops), [("window", *window)], OFFSET)
    cell = find_cell(load_benchmark(), "raisr_x2.batch16")
    return Run(cell, 3.0, Window(0.0, 0.1, calls), 16, 2048 * 2048, {}, frozenset(), trace=t)


def _read(monkeypatch, run, recs):
    monkeypatch.setattr(program, "records", lambda: recs)
    return load_reader(SYNCS)(run), load_reader(IDLE)(run)


# the device's gaps: 10.010-10.012 after a copy, 10.030-10.040 after a
# copy, 10.090-10.095 after a kernel
OPS = [("kernel", 10.0, 10.0099), (COPY, 10.0099, 10.010), ("kernel", 10.012, 10.0299),
       (COPY, 10.0299, 10.030), ("kernel", 10.040, 10.090), ("kernel", 10.095, 10.1)]
RECORD = [
    # a call that opened before the window: not counted
    _span("ocv.raisr", 0, 0.44, 0.4999, syncs=[0.4505]),
    # two sampled calls inside it, host times (profiler times less 9.5)
    _span("ocv.raisr", 16, 0.5, 0.58, syncs=[0.511]),
    _span("ocv.raisr.in", 16, 0.529, 0.532, parent=1, syncs=[0.535]),
    _span("ocv.raisr", 32, 0.585, 0.6, syncs=[0.5935]),
]


def test_both_readers_give_the_hand_computed_values(monkeypatch):
    syncs, idle = _read(monkeypatch, _run(OPS), RECORD)
    assert syncs == pytest.approx(3 / 2)  # per sampled call
    assert idle == pytest.approx(1e3 * (0.002 + 0.010) / 4)  # per call of the window


def test_both_readers_return_none_with_nothing_to_read(monkeypatch):
    assert _read(monkeypatch, _run(OPS), []) == (None, None)  # an empty record
    assert _read(monkeypatch, _run(OPS), RECORD[:1]) == (None, None)  # no call in the window
    untraced = _run(OPS)
    untraced.trace = None
    assert _read(monkeypatch, untraced, RECORD) == (None, None)


def test_a_gap_cut_by_the_window_end_counts_only_inside_it(monkeypatch):
    # the last copy ends at 10.090 and the device is idle past the window's end
    run = _run([("kernel", 10.0, 10.089), (COPY, 10.089, 10.090)], calls=1)
    rec = [_span("ocv.raisr", 0, 0.5, 0.6, syncs=[0.596])]
    assert _read(monkeypatch, run, rec) == (1.0, pytest.approx(1e3 * 0.010))


def test_a_span_outside_the_window_is_not_counted(monkeypatch):
    late = _span("ocv.raisr", 48, 0.61, 0.62, syncs=[0.611])  # opens at 10.11, after the window
    assert _read(monkeypatch, _run(OPS), RECORD + [late]) == _read(monkeypatch, _run(OPS), RECORD)


@pytest.mark.parametrize("ops, why", [
    ([("kernel", 10.0, 10.03), ("Memcpy DtoD (Device -> Device)", 10.03, 10.031)],
     "a copy that no host memory takes part in"),
    ([("kernel", 10.0, 10.03), (COPY, 10.03, 10.031), ("kernel", 10.031, 10.1)],
     "a pageable copy that the device runs on from into the next kernel"),
    ([("kernel", 10.0, 10.03), (COPY, 10.02, 10.025)], "a pageable copy under a kernel"),
])
def test_only_a_gap_that_opens_where_a_pageable_copy_ends_counts(monkeypatch, ops, why):
    rec = [_span("ocv.raisr", 0, 0.5, 0.6)]
    assert _read(monkeypatch, _run(ops, calls=1), rec) == (0.0, 0.0), why


def test_the_drain_is_read_on_the_device_track_whatever_the_host_times(monkeypatch):
    """The host times of the syncs, and their spans, may lie anywhere: the
    profiler's host and device clocks drift apart within a window."""
    drifted = [_span("ocv.raisr", 16, 0.5, 0.58, syncs=[0.5001]),
               _span("ocv.raisr.in", 16, 0.5002, 0.5003, parent=0, syncs=[0.5999])]
    assert _read(monkeypatch, _run(OPS), drifted) == (2.0, pytest.approx(1e3 * 0.012 / 4))


def test_the_parent_without_a_tracer_reads_nothing(monkeypatch):
    import builtins

    real = builtins.__import__

    def no_tracer(name, *args, **kwargs):
        if name == "oclcomputervision_tpu_torch.utils" and "tracing" in (args[2] or ()):
            raise ImportError("cannot import name 'tracing'")
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_tracer)
    assert program.records() == []
    assert (load_reader(SYNCS)(_run(OPS)), load_reader(IDLE)(_run(OPS))) == (None, None)
