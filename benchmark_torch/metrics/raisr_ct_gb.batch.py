"""GB a call that the card's caching allocator hands out inside the
program's census-transform blend (``ocv.raisr.ct``: the weights and the
blend of every channel), summed over the window's sampled calls, per
sampled call. None without such a span."""

from benchmark_torch.common.allocs import span_gb_per_call


def read(run):
    return span_gb_per_call(run, "ocv.raisr.ct")
