"""Frame pairs [2, h, w] for CPU rehearsals: the centre h x w of
``middlebury_pairs``' stored pair (cropped, never resampled), each frame of
each item given its own additive noise from [-4, 4] as there. A rehearsal
on the CPU cannot afford the whole 480 x 640 pair in the calls of its short
windows."""

from __future__ import annotations

import torch

from benchmark_torch.content import middlebury_pairs as pairs

PLANES = pairs.PLANES


def make(gen, n: int, h: int, w: int, device) -> torch.Tensor:
    """uint8 [n, 2, h, w] on ``device``: the centre h x w of the pair, with
    noise from [-4, 4] drawn for every pixel of every frame of every item."""
    fh, fw = pairs.FRAME
    if not (0 < h <= fh and 0 < w <= fw):
        raise ValueError(f"middlebury_crops crops the {fh} x {fw} pair, not to {h} x {w}")
    y0, x0 = (fh - h) // 2, (fw - w) // 2
    base = torch.from_numpy(pairs.frames()[:, y0 : y0 + h, x0 : x0 + w].copy())
    base = base.to(device).to(torch.int16)
    noise = torch.randint(-pairs.NOISE, pairs.NOISE + 1, (n, PLANES, h, w), generator=gen,
                          device=device, dtype=torch.int16)
    return torch.clamp(base + noise, 0, 255).to(torch.uint8)
