"""The comparisons that decide ``correct``: the program's uint8 outputs
against the plain reference's, on the same inputs."""

from __future__ import annotations

from typing import Sequence

import torch


def off_gt1_share(program: Sequence[torch.Tensor], reference: Sequence[torch.Tensor]) -> float:
    """The largest, over the paired outputs, share of pixels more than one
    level from the reference's (a missing or misshapen output reads 1)."""
    if len(program) != len(reference):
        return 1.0
    worst = 0.0
    for p, r in zip(program, reference):
        p = p.to(r.device)
        if tuple(p.shape) != tuple(r.shape) or p.dtype != r.dtype:
            return 1.0
        off = (p.to(torch.int16) - r.to(torch.int16)).abs() > 1
        worst = max(worst, off.to(torch.float64).mean().item())
    return worst
