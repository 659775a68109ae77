"""Device checks: the port never falls back to the CPU on its own."""

from __future__ import annotations

import torch


def require_cuda() -> torch.device:
    """The first CUDA device; raises if torch sees none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "torch.cuda.is_available() is False: this needs an NVIDIA GPU "
            "and a CUDA build of PyTorch"
        )
    return torch.device("cuda", 0)


def as_device(device) -> torch.device:
    """Validate an explicit device argument ('cuda', 'cuda:0' or 'cpu')."""
    if device is None:
        raise ValueError("pass a device explicitly, for example 'cuda' or 'cpu'")
    dev = torch.device(device)
    if dev.type == "cuda":
        require_cuda()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev
