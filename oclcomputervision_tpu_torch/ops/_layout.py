"""Rank-3 layout guards of the public ops (a copy of the JAX package's
``ops/_layout.py``).

The ops split into two rank-3 conventions: the luma ops (histeq, motion
estimation) read batch-first ``[B, H, W]``, the channels-last ops
(pyr_down) read ``[H, W, C]``.

- channels-last ops take ``batched=None``: the default reads a trailing dim
  <= MAX_CHANNELS as channels and raises on anything wider, asking for an
  explicit ``batched=``; True forces [B, H, W], False forces [H, W, C].
- batch-first ops raise when a rank-3 input's trailing dim looks like
  channels (<= MAX_CHANNELS): no real luma batch has a 4-px-wide image, so
  such an input is a channels-last color image passed by mistake.
"""

from __future__ import annotations

MAX_CHANNELS = 4


def rank3_is_batched(shape, batched, op: str) -> bool:
    """Resolve a channels-last op's rank-3 layout: True = [B, H, W]."""
    if batched is not None:
        return bool(batched)
    if shape[-1] <= MAX_CHANNELS:
        return False
    raise ValueError(
        f"{op}: ambiguous rank-3 input {tuple(shape)} - trailing dim "
        f"{shape[-1]} > {MAX_CHANNELS} does not look like channels. Pass "
        f"batched=True for a [B, H, W] luma stack or batched=False for "
        f"[H, W, C]."
    )


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
