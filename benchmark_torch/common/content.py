"""Input frames from the seed: lenna's luma tiled to the frame, each frame
rolled by its own offset and given additive noise in [-8, 8].

A copy of ``chip_smoke.lenna_batch`` (bench.py's RAISR input), made on the
device with a seeded ``torch.Generator`` in a few large calls so that
set-up stays short. ``lenna_gray.npz`` beside this file is the port's
rounded BT.601 luma of ``assets/lenna.png`` (512 x 512 uint8), kept here so
that the traffic does not change when the program's assets or PNG reader
do. Rolling the noisy tile or adding noise to the rolled tile gives the
same distribution, since the noise is independent per pixel.
"""

from __future__ import annotations

import os

import numpy as np
import torch

_LENNA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "lenna_gray.npz")
ROLL_RANGE = 512  # chip_smoke.lenna_batch's rng.integers(0, 512, 2)
NOISE = 8


def lenna_gray() -> np.ndarray:
    with np.load(_LENNA) as z:
        return z["gray"]


def generator(seed: int, device: torch.device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (any whole number
    that fits 64 bits, taken modulo 2**64)."""
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 64))


def lenna_frames(gen: torch.Generator, n: int, h: int, w: int, device) -> torch.Tensor:
    """uint8 [n, h, w] on ``device``: lenna tiled to h x w, frame k rolled
    by (r_k, c_k) drawn from [0, 512) and given noise from [-8, 8]."""
    base = torch.from_numpy(lenna_gray()).to(device)
    bh, bw = base.shape
    tile = base[torch.arange(h, device=device) % bh][:, torch.arange(w, device=device) % bw]
    shifts = torch.randint(0, ROLL_RANGE, (n, 2), generator=gen, device=device)
    rows = (torch.arange(h, device=device)[None, :] - shifts[:, :1]) % h  # [n, h]
    cols = (torch.arange(w, device=device)[None, :] - shifts[:, 1:]) % w  # [n, w]
    rolled = tile[rows[:, :, None], cols[:, None, :]]  # out[i] = in[(i - shift) % h], np.roll
    noise = torch.randint(-NOISE, NOISE + 1, (n, h, w), generator=gen, device=device,
                          dtype=torch.int16)
    return torch.clamp(rolled.to(torch.int16) + noise, 0, 255).to(torch.uint8)
