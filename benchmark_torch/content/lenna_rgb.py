"""RGB frames [h, w, 3]: lenna in colour tiled to the frame, each frame
rolled by its own offset drawn from [0, 512) and given noise from [-8, 8]
per sample, from the seed: ``common.content.lenna_frames``'s recipe with
three channels, made on the device in a few large calls.

``lenna_rgb.npz`` beside this file is ``assets/lenna.png`` as the port's
PNG reader decodes it (512 x 512 x 3 uint8), kept here so that the traffic
does not change when the program's assets or PNG reader do.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from benchmark_torch.common.content import NOISE, ROLL_RANGE

PLANES = 3
_LENNA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "lenna_rgb.npz")


def lenna_rgb() -> np.ndarray:
    with np.load(_LENNA) as z:
        return z["rgb"]


def make(gen, n: int, h: int, w: int, device) -> torch.Tensor:
    """uint8 [n, h, w, 3] on ``device``: lenna tiled to h x w, frame k
    rolled by (r_k, c_k) drawn from [0, 512) and each sample given noise
    from [-8, 8]."""
    base = torch.from_numpy(lenna_rgb()).to(device)
    bh, bw = base.shape[:2]
    tile = base[torch.arange(h, device=device) % bh][:, torch.arange(w, device=device) % bw]
    shifts = torch.randint(0, ROLL_RANGE, (n, 2), generator=gen, device=device)
    rows = (torch.arange(h, device=device)[None, :] - shifts[:, :1]) % h  # [n, h]
    cols = (torch.arange(w, device=device)[None, :] - shifts[:, 1:]) % w  # [n, w]
    rolled = tile[rows[:, :, None], cols[:, None, :]]  # out[i] = in[(i - shift) % h], np.roll
    noise = torch.randint(-NOISE, NOISE + 1, (n, h, w, 3), generator=gen, device=device,
                          dtype=torch.int16)
    return torch.clamp(rolled.to(torch.int16) + noise, 0, 255).to(torch.uint8)
