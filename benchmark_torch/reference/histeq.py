"""Plain PyTorch global histogram equalization of uint8 [B, H, W] images.

Upstream ``histeq/eq_global.py:10-39``: per image, the 256-bin histogram;
its CDF; the punch quantiles (first bin whose CDF reaches ``punch`` and
``1 - punch``); the CDF of the histogram between them, 0 below and 1 from
the upper one on; the mapping alpha * 255 * CDF + (1 - alpha) * I, clamped
to [0, 255] and held to the gain limits [I / clip, I * clip]; the LUT is
the mapping cast to uint8 (truncated). ``dtype`` is the precision the
mapping is computed in (float32 as stated).
"""

from __future__ import annotations

import torch


def _div(x: torch.Tensor, d) -> torch.Tensor:
    d = d if isinstance(d, torch.Tensor) else torch.tensor(d, dtype=x.dtype, device=x.device)
    return x / d


def transfer_luts(hist: torch.Tensor, alpha: float, punch: float, clip: float,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[B, 256] counts -> uint8 LUTs [B, 256]."""
    hist = hist.to(dtype)
    idx = torch.arange(256, dtype=dtype, device=hist.device)
    cdf = _div(torch.cumsum(hist, -1), hist.sum(-1, keepdim=True))

    def first(cond):
        return cond.to(torch.int32).argmax(-1, keepdim=True).to(dtype)

    dark, bright = first(cdf >= punch), first(cdf >= 1.0 - punch)
    punched = torch.where((idx >= dark) & (idx < bright), hist, 0.0)
    cdf_p = _div(torch.cumsum(punched, -1), punched.sum(-1, keepdim=True))
    cdf = torch.where(idx < dark, 0.0, torch.where(idx >= bright, 1.0, cdf_p))
    mapping = torch.clamp(alpha * cdf * 255.0 + (1.0 - alpha) * idx, 0.0, 255.0)
    mapping = torch.minimum(torch.maximum(mapping, _div(idx, clip)), idx * clip)
    return mapping.to(torch.uint8)


def equalize(x: torch.Tensor, alpha: float, punch: float, clip: float,
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 [B, H, W] -> uint8 [B, H, W]."""
    flat = x.reshape(x.shape[0], -1).to(torch.int64)
    hist = torch.zeros((x.shape[0], 256), dtype=torch.int64, device=x.device)
    hist.scatter_add_(1, flat, torch.ones_like(flat))
    luts = transfer_luts(hist, alpha, punch, clip, dtype)
    return torch.gather(luts, 1, flat).reshape(x.shape)
