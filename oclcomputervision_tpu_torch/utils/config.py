"""Config dataclasses of the ported ops.

Copies of ``HistEqConfig``, ``LocalHistEqConfig``, ``ResizeConfig``,
``PyramidConfig``, ``MotionConfig`` and ``RaisrConfig`` from
the JAX package's ``utils/config.py``: the same frozen dataclasses, fields
and defaults (``tests/test_torch_port_imports.py`` holds them equal).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class HistEqConfig:
    """Histogram equalization (reference histeq/eq_global.py:39 defaults)."""

    alpha: float = 1.0
    punch: float = 0.05
    clip: float = 2.0
    bins: int = 256
    # Histogram grid tile (reference: 32 rows x 256 cols per workgroup,
    # histeq/eq_opencl.py:12-13,43-44).
    tile: Tuple[int, int] = (32, 256)


@dataclasses.dataclass(frozen=True)
class LocalHistEqConfig(HistEqConfig):
    """Local-block (CLAHE-style) histeq (reference eq_local_block.py:10)."""

    alpha: float = 0.5
    clip: float = 3.0
    blockshape: Tuple[int, int] = (256, 256)


@dataclasses.dataclass(frozen=True)
class ResizeConfig:
    """Interpolation config. align_corners matches the reference kernels
    (basic/interpolation.cl:11,58,92: out/(Wout-1)*(Win-1) mapping)."""

    method: str = "bilinear"  # bilinear | bicubic
    align_corners: bool = True
    # Catmull-Rom a=-0.5 basis (interpolation.cl:73-78).
    cubic_a: float = -0.5


@dataclasses.dataclass(frozen=True)
class PyramidConfig:
    """Gaussian pyramid (reference pyramid/pyramid.py:7)."""

    scale: int = 2
    depth: int = 3


@dataclasses.dataclass(frozen=True)
class MotionConfig:
    """Block-matching motion estimation (reference me_pyramid.py:130)."""

    search_size: int = 15
    patch_size: int = 5
    levels: int = 3


@dataclasses.dataclass(frozen=True)
class RaisrConfig:
    """RAISR (reference super_resolution/raisr.{py,cl}).

    ``fidelity='shipped'`` reproduces the reference's observable behavior:
    the kernel early-returns after the cheap bilinear upscale + YUV
    roundtrip (raisr.cl:219-230) and the hash omits the strength index
    (raisr.cl:316). ``fidelity='full'`` runs the intended RAISR pipeline
    with the reference's kernel bugs fixed (see oracle/raisr.py).
    """

    num_angle: int = 24
    num_strength: int = 3
    num_coherence: int = 3
    filter_len: int = 11
    gauss_len: int = 9  # FILTER_LEN - 2 (raisr.cl:39)
    gauss_sigma: float = 2.0
    scale: int = 2
    strength_quantizers: Tuple[float, ...] = (1e-4, 1e-3)  # raisr.py:112
    coherence_quantizers: Tuple[float, ...] = (0.25, 0.5)  # raisr.py:114
    fidelity: str = "full"  # 'full' | 'shipped'
    # 'ct': census-transform structure blending (RAISR paper §V) of the
    # filtered output with the cheap upscale; 'none' = filtered output
    # as-is. Applies to fidelity='full' only.
    blend: str = "none"  # 'none' | 'ct'
    # The TPU hash kernel's variant name; the port's hash kernel has one
    # form (the XLA twin's atan2 bucketing) and carries the field only so
    # that configs cross between the packages unchanged.
    hash_mode: str = "ratio_sym_roll_ns"

    @property
    def num_pixel_type(self) -> int:
        return self.scale * self.scale

    @property
    def num_filters(self) -> int:
        return self.num_angle * self.num_strength * self.num_coherence * self.num_pixel_type

