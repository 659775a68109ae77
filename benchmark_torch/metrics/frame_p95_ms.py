"""95th percentile, over every frame of the window, of the time from the
frame's due time to its result in host memory (host clock)."""

from benchmark_torch.common.readers import frame_latency_ms


def read(run):
    return frame_latency_ms(run, 95.0)
