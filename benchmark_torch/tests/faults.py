"""The faults a cell can have under its timed path, each a function of the
program's main output that a configuration's ``plant`` routes the output
through. ``FAULTS`` makes a fresh one per run."""

import torch


def altered(out):
    """An answer altered where it is produced: a uint8 output three levels
    up (clamped), a floating one 3.0 up."""
    if out.dtype.is_floating_point:
        return out + 3.0
    return torch.clamp(out.to(torch.int16) + 3, 0, 255).to(torch.uint8)


def half_left_out(out):
    """Half of the batch left out: its second half a copy of the first."""
    if out.ndim < 3:
        return out
    out = out.clone()
    n = out.shape[0] // 2
    out[out.shape[0] - n:] = out[:n]
    return out


class Stale:
    """A step that returns its state unchanged: every call after the first
    hands back the first call's result."""

    def __init__(self):
        self.first = None

    def __call__(self, out):
        if self.first is None or self.first.shape != out.shape:
            self.first = out
        return self.first


FAULTS = {"altered": lambda: altered, "half_left_out": lambda: half_left_out, "stale": Stale}
