"""Single frames [h, w]: ``common.content.lenna_frames`` (lenna's luma tiled
to the frame, rolled and given noise from the seed)."""

from __future__ import annotations

from benchmark_torch.common.content import lenna_frames

PLANES = 1


def make(gen, n: int, h: int, w: int, device):
    return lenna_frames(gen, n, h, w, device)
