"""GB a call that the card's caching allocator hands out inside the
program's colour-space conversions (``ocv.raisr.csc``: RGB -> YUV of the
upscale's planes and YUV -> RGB of the filtered ones), summed over the
window's sampled calls, per sampled call. None without such a span."""

from benchmark_torch.common.allocs import span_gb_per_call


def read(run):
    return span_gb_per_call(run, "ocv.raisr.csc")
