"""Synchronising CUDA calls per call that the program makes inside its own
spans: its tracer's ``syncs`` counter summed over the window's sampled calls,
per sampled call."""

from benchmark_torch.common.program import syncs_per_call


def read(run):
    return syncs_per_call(run)
