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
from oclcomputervision_tpu_torch.ops.interpolation import resize, resize_uint8
from oclcomputervision_tpu_torch.ops.motion import (
    estimate_motion_pyramid,
    estimate_motion_vector,
    exact_flow_bound,
    median_filter_flow,
    refine_flow_subpixel,
    resize_bilinear_halfpixel,
    upscale_mv,
)
from oclcomputervision_tpu_torch.ops.pyramid import gaussian_pyramid, pyr_down

__all__ = [
    "apply_block_mappings",
    "apply_lut",
    "block_mappings",
    "calc_transfer_func",
    "clip_histogram",
    "estimate_motion_pyramid",
    "estimate_motion_vector",
    "exact_flow_bound",
    "gaussian_pyramid",
    "hist_grid",
    "histeq_global",
    "histeq_local_block",
    "histogram256",
    "median_filter_flow",
    "pyr_down",
    "refine_flow_subpixel",
    "resize",
    "resize_bilinear_halfpixel",
    "resize_uint8",
    "upscale_mv",
]
