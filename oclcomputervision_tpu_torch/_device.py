"""Device rules: the port runs on the card unless the caller asks for the
CPU, and never falls back to the CPU on its own."""

from __future__ import annotations

import numpy as np
import torch


def require_cuda() -> torch.device:
    """The first CUDA device; raises if torch sees none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "torch.cuda.is_available() is False: this needs an NVIDIA GPU "
            "and a CUDA build of PyTorch"
        )
    return torch.device("cuda", 0)


def as_device(device=None) -> torch.device:
    """The device to run on: None means the card (``require_cuda``);
    'cuda', 'cuda:0' or 'cpu' are taken as given. Only 'cpu' gives the CPU."""
    if device is None:
        return require_cuda()
    dev = torch.device(device)
    if dev.type == "cuda":
        require_cuda()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev


def as_tensor(x, device=None) -> torch.Tensor:
    """A tensor stays on its device unless one is given; anything else goes
    through numpy to ``as_device(device)`` (the card by default)."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(as_device(device))
    arr = np.asarray(x)
    if not arr.flags.writeable:  # torch wants writable memory
        arr = arr.copy()
    return torch.from_numpy(arr).to(as_device(device))
