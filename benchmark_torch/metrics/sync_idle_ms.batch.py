"""Device idle ms per call after the program's synchronising copies: the
window's idle gaps that open where a copy to or from pageable host memory
ends, from the queue draining to the host's next launch."""

from benchmark_torch.common.program import sync_idle_ms_per_call


def read(run):
    return sync_idle_ms_per_call(run)
