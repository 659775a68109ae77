"""Rank-3 layout guard of the batch-first ops (a copy of the JAX package's
``ops/_layout.guard_batch_first``).

The luma ops (histeq) read rank-3 input as a batch-first ``[B, H, W]``
stack. A rank-3 input whose trailing dim looks like channels (<=
MAX_CHANNELS) is a channels-last color image passed by mistake: no real
luma batch has a 4-px-wide image, so it raises.
"""

from __future__ import annotations

MAX_CHANNELS = 4


def guard_batch_first(shape, op: str) -> None:
    """Reject channels-last-looking rank-3 inputs to a [B, H, W] op."""
    if shape[-1] <= MAX_CHANNELS:
        raise ValueError(
            f"{op} reads rank-3 input as a batch-first [B, H, W] luma "
            f"stack, but {tuple(shape)} has a {shape[-1]}-wide trailing "
            f"dim - this looks like a channels-last [H, W, C] image. "
            f"Convert color to luma first (e.g. the Y channel), or pass "
            f"per-channel planes as the batch axis."
        )
