"""Global histogram equalization kernels: row histograms and row LUT apply.

Ports of ``oclcomputervision_tpu/ops/pallas/histeq_pallas.py``:

- ``hist256`` (plain) / ``hist256_kernel`` (wrapper over ``csrc/hist256.cu``)
  replace ``hist256_pallas``: [B, N] uint8 -> [B, 256] float32 exact counts,
  for any N (no tile padding, so no pad count to take out of bin 0).
- ``apply_lut`` (plain) / ``apply_lut_kernel`` (``csrc/apply_lut.cu``)
  replace ``apply_lut_pallas``: [B, N] uint8 with [B, 256] uint8 LUTs ->
  [B, N] uint8.

Counts are integers and LUT values are bytes, so kernel and plain version
agree exactly. Each wrapper takes the plain version for a CPU tensor and
launches its kernel for a CUDA tensor.
"""

from __future__ import annotations

import torch

from oclcomputervision_tpu_torch.kernels._build import launch, require_cuda_tensor

MAX_ROW = 1 << 30  # bytes per row: the kernels index rows with 32-bit ints
MAX_GRID_YZ = 65535


def _check_rows(b: int, n: int) -> None:
    if b > MAX_GRID_YZ or n >= MAX_ROW:
        raise ValueError(f"[{b}, {n}] exceeds the kernels' grid (<= {MAX_GRID_YZ} rows "
                         f"of < {MAX_ROW} bytes)")


def hist256(x: torch.Tensor) -> torch.Tensor:
    """Plain version: [B, N] uint8 -> [B, 256] float32 counts."""
    counts = torch.zeros((x.shape[0], 256), dtype=torch.int32, device=x.device)
    ones = torch.ones((1, 1), dtype=torch.int32, device=x.device).expand(x.shape)
    counts.scatter_add_(1, x.long(), ones)
    return counts.float()


def hist256_kernel(x: torch.Tensor) -> torch.Tensor:
    """Wrapper: the plain version for a CPU tensor, the CUDA kernel for a
    CUDA tensor (contiguous [B, N] uint8)."""
    if x.device.type == "cpu":
        return hist256(x)
    require_cuda_tensor(x, "x", torch.uint8, 2)
    b, n = x.shape
    _check_rows(b, n)
    counts = torch.empty((b, 256), dtype=torch.int32, device=x.device)
    launch("hist256", "ocvk_hist256", x.device, x.data_ptr(), counts.data_ptr(), b, n)
    return counts.float()


def apply_lut(x: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """Plain version: out[b, p] = luts[b, x[b, p]]."""
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    return luts[rows, x.long()]


def apply_lut_kernel(x: torch.Tensor, luts: torch.Tensor) -> torch.Tensor:
    """Wrapper: the plain version for a CPU tensor, the CUDA kernel for a
    CUDA tensor (contiguous [B, N] uint8 and [B, 256] uint8 LUTs)."""
    if x.device.type == "cpu":
        return apply_lut(x, luts)
    require_cuda_tensor(x, "x", torch.uint8, 2)
    require_cuda_tensor(luts, "luts", torch.uint8, 2)
    b, n = x.shape
    if tuple(luts.shape) != (b, 256) or luts.device != x.device:
        raise ValueError(f"luts must be [{b}, 256] on {x.device}, got {tuple(luts.shape)}")
    _check_rows(b, n)
    out = torch.empty_like(x)
    launch(
        "apply_lut", "ocvk_apply_lut", x.device,
        x.data_ptr(), luts.data_ptr(), out.data_ptr(), b, n,
    )
    return out
