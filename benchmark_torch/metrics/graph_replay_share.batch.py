"""The share of the window's sampled motion calls that replayed a captured
CUDA graph, in %: the calls whose outermost span ``ocv.motion`` holds the
span ``ocv.motion.replay``. None where the record has no sampled motion
call, and for a program whose motion call never replays (one without the
counter ``ops.motion.GRAPH_CALLS``)."""

from benchmark_torch.common.program import window_calls

CALL, REPLAY = "ocv.motion", "ocv.motion.replay"


def read(run):
    try:
        from oclcomputervision_tpu_torch.ops import motion
    except ImportError:
        return None
    if not hasattr(motion, "GRAPH_CALLS"):
        return None
    got = window_calls(run)
    if got is None:
        return None
    spans, _ = got
    calls = {r.call for r in spans if r.parent is None and r.name == CALL}
    if not calls:
        return None
    replayed = {r.call for r in spans if r.name == REPLAY and r.call in calls}
    return 100.0 * len(replayed) / len(calls)
