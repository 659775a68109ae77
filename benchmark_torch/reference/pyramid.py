"""Plain PyTorch Gaussian pyramid of uint8 [B, H, W] images.

cv2.pyrDown, as upstream ``pyramid/pyramid.py:7-21`` calls it: the 5 x 5
binomial blur ([1, 4, 6, 4, 1] / 16 each way) with reflect-101 borders,
then every second row and column from the first; each level rounded half
to even to uint8. The list runs from the coarsest level to the input.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

K = (1.0 / 16, 4.0 / 16, 6.0 / 16, 4.0 / 16, 1.0 / 16)


def pyr_down(x: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 [B, H, W] -> uint8 [B, H // 2, W // 2]."""
    h, w = x.shape[1:]
    xp = F.pad(x.to(torch.float32)[:, None], (2, 2, 2, 2), mode="reflect")[:, 0].to(dtype)
    v = sum(K[k] * xp[:, k : k + h, :] for k in range(5))
    b = sum(K[k] * v[:, :, k : k + w] for k in range(5))
    out = b[:, 0 : 2 * (h // 2) : 2, 0 : 2 * (w // 2) : 2].to(torch.float32)
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)


def pyramid(x: torch.Tensor, depth: int, dtype: torch.dtype = torch.float32):
    """[coarsest, ..., x]: ``depth`` levels of uint8 [B, H, W] ``x``."""
    levels = [x]
    for _ in range(depth - 1):
        levels.insert(0, pyr_down(levels[0], dtype))
    return levels
