"""Plain PyTorch pipelines around the hand-written kernels."""

from oclcomputervision_tpu_torch.ops.histeq import (
    apply_block_mappings,
    apply_lut,
    block_mappings,
    calc_transfer_func,
    clip_histogram,
    hist_grid,
    histeq_global,
    histeq_local_block,
    histogram256,
)

__all__ = [
    "apply_block_mappings",
    "apply_lut",
    "block_mappings",
    "calc_transfer_func",
    "clip_histogram",
    "hist_grid",
    "histeq_global",
    "histeq_local_block",
    "histogram256",
]
