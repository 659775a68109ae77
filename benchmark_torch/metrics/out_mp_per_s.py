"""Every output megapixel completed in the window over the window's seconds
(host clock; the window ends when the last call's result is complete)."""

from benchmark_torch.common.stats import rate


def read(run):
    if run.window.frames:
        return None
    mp = run.window.calls * run.frames_per_call * run.out_px_per_frame / 1e6
    return rate(mp, run.window.seconds)
