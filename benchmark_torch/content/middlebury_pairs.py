"""Frame pairs [2, 480, 640]: the Middlebury frame10 / frame11 pair (a real
motion between the two frames), each frame of each item given its own
additive noise from [-4, 4], so that no two items are alike. bench.py's and
``chip_smoke.noisy_pairs``' motion input, made on the device from the seeded
generator.

``middlebury_pairs.npz`` beside this file holds the port's rounded BT.601
luma of ``assets/frame10.png`` and ``assets/frame11.png`` (``frames``, uint8
[2, 480, 640]), kept here so that the traffic does not change when the
program's assets or PNG reader do. The pair is used at its own size and at
no other: nothing is resampled.
"""

from __future__ import annotations

import os

import numpy as np
import torch

_PAIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "middlebury_pairs.npz")
PLANES = 2
FRAME = (480, 640)
NOISE = 4


def frames() -> np.ndarray:
    """The stored pair, uint8 [2, 480, 640]."""
    with np.load(_PAIR) as z:
        return z["frames"]


def make(gen, n: int, h: int, w: int, device) -> torch.Tensor:
    """uint8 [n, 2, 480, 640] on ``device``: the pair, with noise from
    [-4, 4] drawn for every pixel of every frame of every item."""
    if (h, w) != FRAME:
        raise ValueError(f"middlebury_pairs holds {FRAME[0]} x {FRAME[1]} frames, "
                         f"not {h} x {w}: set the mix's frame to {list(FRAME)}")
    base = torch.from_numpy(frames()).to(device).to(torch.int16)
    noise = torch.randint(-NOISE, NOISE + 1, (n, PLANES, h, w), generator=gen, device=device,
                          dtype=torch.int16)
    return torch.clamp(base + noise, 0, 255).to(torch.uint8)
