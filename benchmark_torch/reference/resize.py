"""Plain PyTorch align-corners bicubic resize of uint8 [B, H, W] images.

Upstream ``basic/interpolation.cl:73-211`` (bicubic_lds): source coordinate
o (n_in - 1) / (n_out - 1), the 4 x 4 Catmull-Rom window (a = -0.5) at
offsets -1..2 with clamp-to-edge indices, rows then columns, each pass the
taps added in order in ``dtype`` (float32 as stated), the result clamped to
[0, 255] and rounded half to even.
"""

from __future__ import annotations

import numpy as np
import torch


def cubic_taps(n_out: int, n_in: int, device):
    """Indices [4, n_out] int64 and float32 weights [4, n_out] of one axis
    (coordinates and weights in float64)."""
    o = np.arange(n_out, dtype=np.float64)
    x = o * (n_in - 1) / (n_out - 1) if n_out > 1 else np.zeros(1)
    x0 = np.floor(x)
    u = x - x0
    idx = np.clip(x0.astype(np.int64)[None, :] - 1 + np.arange(4)[:, None], 0, n_in - 1)
    u2, u3 = u * u, u * u * u
    w = np.stack([-0.5 * u + u2 - 0.5 * u3, 1.0 - 2.5 * u2 + 1.5 * u3,
                  0.5 * u + 2.0 * u2 - 1.5 * u3, -0.5 * u2 + 0.5 * u3])
    return (torch.from_numpy(idx).to(device),
            torch.from_numpy(w.astype(np.float32)).to(device))


def bicubic(x: torch.Tensor, out_hw, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 [B, H, W] -> uint8 [B, h_out, w_out]."""
    h_out, w_out = out_hw
    yi, yw = cubic_taps(h_out, x.shape[1], x.device)
    xi, xw = cubic_taps(w_out, x.shape[2], x.device)
    yw, xw = yw.to(dtype), xw.to(dtype)
    src = x.to(dtype)
    rows = torch.zeros((x.shape[0], h_out, x.shape[2]), dtype=dtype, device=x.device)
    for k in range(4):
        rows = rows + yw[k][None, :, None] * src[:, yi[k]]
    out = torch.zeros((x.shape[0], h_out, w_out), dtype=dtype, device=x.device)
    for k in range(4):
        out = out + xw[k][None, None, :] * rows[:, :, xi[k]]
    return torch.round(torch.clamp(out.to(torch.float32), 0.0, 255.0)).to(torch.uint8)
