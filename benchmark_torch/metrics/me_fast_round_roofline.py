"""me_fast_round's least time over its own device time (profiler), in %."""

from benchmark_torch.common.readers import kernel_roofline_pct


def read(run):
    return kernel_roofline_pct(run, "me_fast_round")
