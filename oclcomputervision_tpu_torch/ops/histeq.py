"""Global and local-block (CLAHE-style) histogram equalization in PyTorch.

Port of ``oclcomputervision_tpu/ops/histeq.py`` with its Pallas paths
(``ops/pallas/histeq_pallas.py``, ``localeq_pallas.py``):

- global: row histograms (``kernels.histeq.hist256_kernel``) -> transfer LUTs
  (``calc_transfer_func``, 256-wide plain PyTorch) -> LUT apply
  (``kernels.histeq.apply_lut_kernel``);
- local: block histograms (``kernels.localeq.hist_tiles_kernel``) -> optional
  CLAHE clip (``clip_histogram``) -> block LUTs -> bilinear 4-LUT blend
  (``kernels.localeq.blend_blocks_kernel``).

Numpy inputs run on the card unless ``device="cpu"`` is passed; a torch
tensor runs on its own device (the CUDA kernels for a CUDA tensor, their
plain versions for a CPU tensor). Results are uint8 tensors on that device.

Numerics follow the XLA twins. Where JAX divides, the port divides by a
device tensor (on CUDA, ``tensor / python_float`` multiplies by the
reciprocal). Histogram counts are exact integers in float32, so their
cumulative sums are exact in any order and the uint8 LUTs equal JAX's at
alpha = 1; elsewhere XLA:CPU's fused multiply-adds can move a float LUT
entry by one ULP.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from oclcomputervision_tpu_torch._device import as_tensor
from oclcomputervision_tpu_torch.kernels import histeq as khisteq
from oclcomputervision_tpu_torch.kernels import localeq as klocaleq
from oclcomputervision_tpu_torch.ops._layout import guard_batch_first


class Stages(NamedTuple):
    """The four kernel stages the histeq ops run."""

    hist256: Callable
    apply_lut: Callable
    hist_tiles: Callable
    blend: Callable


# the kernel wrappers (plain versions for CPU tensors, kernels for CUDA ones)
KERNEL_STAGES = Stages(
    khisteq.hist256_kernel,
    khisteq.apply_lut_kernel,
    klocaleq.hist_tiles_kernel,
    klocaleq.blend_blocks_kernel,
)
# the plain PyTorch versions on any device (the kernels' reference on the card)
PLAIN_STAGES = Stages(
    khisteq.hist256, khisteq.apply_lut, klocaleq.hist_tiles, klocaleq.blend_blocks
)


def _image(gray, device) -> torch.Tensor:
    """A contiguous uint8 tensor (``as_tensor``'s device rule)."""
    t = as_tensor(gray, device)
    if t.dtype != torch.uint8:
        raise TypeError(f"expected uint8 pixels, got {t.dtype}")
    return t.contiguous()


def _luma(gray, device, op: str):
    """[H, W] or batch-first [B, H, W] uint8 -> ([B, H, W], whether the input
    was one [H, W] image); a channels-last-looking rank-3 input raises."""
    g = _image(gray, device)
    if g.ndim == 3:
        guard_batch_first(g.shape, op)
    elif g.ndim != 2:
        raise ValueError(f"{op} takes [H, W] or [B, H, W], got {tuple(g.shape)}")
    return (g[None], True) if g.ndim == 2 else (g, False)


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d as a true float32 division on x's device."""
    return x / torch.tensor(d, dtype=torch.float32, device=x.device)


def histogram256(x, dtype=torch.int32, *, device=None) -> torch.Tensor:
    """Histogram of uint8 values along the last axis: [..., N] -> [..., 256]."""
    t = _image(x, device)
    counts = khisteq.hist256_kernel(t.reshape(-1, t.shape[-1]))
    return counts.reshape(t.shape[:-1] + (256,)).to(dtype)


def hist_grid(gray, tile: Tuple[int, int] = (32, 256), *, device=None) -> torch.Tensor:
    """Per-tile histogram grid int32 [H//th, W//tw, 256] of an [H, W] image
    (hist.cl:41-90 layout); the tile must divide the image."""
    g = _image(gray, device)
    if g.ndim != 2:
        raise ValueError(f"hist_grid takes [H, W], got {tuple(g.shape)}")
    return klocaleq.hist_tiles_kernel(g[None], tuple(tile))[0].to(torch.int32)


def calc_transfer_func(
    hist: torch.Tensor, alpha: float, punch: float, clip: float
) -> torch.Tensor:
    """256-entry float32 transfer LUT(s), batched over leading dims:
    CDF -> punch requantize -> alpha-blend with identity -> clip [0, 255] ->
    gain limit [I/clip, I*clip] (eq_global.py:10-37). [..., 256] -> [..., 256]."""
    hist = hist.to(torch.float32)
    n = hist.shape[-1]
    idx = torch.arange(n, dtype=torch.float32, device=hist.device)

    cdf = torch.cumsum(hist, -1) / torch.sum(hist, -1, keepdim=True)

    # first index where the CDF reaches the quantile (argmax of a bool:
    # cast first, as CUDA's argmax takes no bool; ties give the first index)
    def first(cond):
        return cond.to(torch.int32).argmax(-1, keepdim=True).to(torch.float32)

    dark = first(cdf >= punch)
    bright = first(cdf >= 1.0 - punch)

    in_punch = (idx >= dark) & (idx < bright)
    hp = torch.where(in_punch, hist, 0.0)
    cdf_punched = torch.cumsum(hp, -1) / torch.sum(hp, -1, keepdim=True)
    cdf = torch.where(idx < dark, 0.0, torch.where(idx >= bright, 1.0, cdf_punched))

    mapping = alpha * cdf * 255.0 + (1.0 - alpha) * idx
    mapping = torch.clamp(mapping, 0.0, 255.0)
    return torch.minimum(torch.maximum(mapping, _div(idx, clip)), idx * clip)


def clip_histogram(hist: torch.Tensor, clip_limit: float) -> torch.Tensor:
    """CLAHE contrast limiting (batched over leading dims): cap bins at
    clip_limit * mean-count, redistribute the excess uniformly."""
    hist = hist.to(torch.float32)
    n = hist.shape[-1]
    limit = _div(clip_limit * torch.sum(hist, -1, keepdim=True), n)
    clipped = torch.minimum(hist, limit)
    excess = torch.sum(hist - clipped, -1, keepdim=True)
    return clipped + _div(excess, n)


def apply_lut(gray, lut, *, device=None) -> torch.Tensor:
    """Per-pixel LUT apply of a uint8 LUT [256]: out[p] = lut[gray[p]]
    (hist.cl:92-102), any shape."""
    g = _image(gray, device)
    lut_t = as_tensor(lut, g.device)
    if lut_t.dtype != torch.uint8 or tuple(lut_t.shape) != (256,):
        raise TypeError(f"lut must be uint8 [256], got {lut_t.dtype} {tuple(lut_t.shape)}")
    out = khisteq.apply_lut_kernel(g.reshape(1, -1), lut_t.reshape(1, 256).contiguous())
    return out.reshape(g.shape)


def histeq_global(
    gray, alpha: float = 1.0, punch: float = 0.05, clip: float = 2.0, *, device=None
) -> torch.Tensor:
    """Global histogram equalization of uint8 [H, W] or [B, H, W]
    (defaults of eq_global.py:39): per image, histogram -> uint8 transfer
    LUT (truncating cast) -> LUT apply. Any geometry."""
    g3, single = _luma(gray, device, "histeq_global")
    out = _histeq_global_batched(g3, alpha, punch, clip)
    return out[0] if single else out


def _histeq_global_batched(
    g3: torch.Tensor, alpha: float, punch: float, clip: float, stages: Stages = KERNEL_STAGES
) -> torch.Tensor:
    """[B, H, W] uint8 -> [B, H, W] uint8 through ``stages``."""
    flat = g3.reshape(g3.shape[0], -1)
    luts = calc_transfer_func(stages.hist256(flat), alpha, punch, clip).to(torch.uint8)
    return stages.apply_lut(flat, luts).reshape(g3.shape)


def block_mappings(
    gray,
    alpha: float,
    punch: float,
    clip: float,
    blockshape: Tuple[int, int],
    clahe_clip: float = 0.0,
    *,
    device=None,
) -> torch.Tensor:
    """Per-block float32 transfer LUTs [nby, nbx, 256] of an [H, W] image
    ([B, nby, nbx, 256] for [B, H, W]); the blocks must divide the image.
    ``clahe_clip`` > 0 applies CLAHE contrast limiting per block first."""
    g3, single = _luma(gray, device, "block_mappings")
    m4 = _block_mappings_batched(g3, alpha, punch, clip, tuple(blockshape), clahe_clip)
    return m4[0] if single else m4


def _block_mappings_batched(
    g3, alpha, punch, clip, blockshape, clahe_clip, stages: Stages = KERNEL_STAGES
) -> torch.Tensor:
    grid = stages.hist_tiles(g3, blockshape)
    if clahe_clip > 0:
        grid = clip_histogram(grid, clahe_clip)
    return calc_transfer_func(grid, alpha, punch, clip)


def apply_block_mappings(
    gray, mappings, blockshape: Tuple[int, int], *, device=None
) -> torch.Tensor:
    """Bilinear blend of the 4 nearest block LUTs (hist.cl:104-147): uint8
    [H, W] with mappings [nby, nbx, 256], or [B, H, W] with [B, nby, nbx, 256].

    Trunc-toward-zero block indexing from block centers, s/t in [0, 1],
    edge blocks clamped, float32 blend, truncating uint8 cast: the XLA
    twin's arithmetic. Any image that fits the grid shifted by half a
    block (H <= (nby + 1) bh - bh/2, likewise W) is accepted.
    """
    g3, single = _luma(gray, device, "apply_block_mappings")
    m4 = as_tensor(mappings, g3.device).to(torch.float32)
    if single:
        m4 = m4[None]
    if m4.ndim != 4 or m4.shape[0] != g3.shape[0] or m4.shape[-1] != 256:
        raise ValueError(f"mappings {tuple(m4.shape)} do not match images {tuple(g3.shape)}")
    out = klocaleq.blend_blocks_kernel(g3, m4.contiguous(), tuple(blockshape))
    return out[0] if single else out


def apply_block_mappings_band(
    band, mappings, blockshape: Tuple[int, int], ty0: int, w: int, *, device=None
) -> torch.Tensor:
    """Blend a blend-tile-aligned row band against the global LUT grid
    (``ops/histeq.apply_block_mappings_band`` of the JAX package).

    ``band`` uint8 [nty_loc * bh, w] holds padded rows [ty0 * bh,
    (ty0 + nty_loc) * bh) of the half-block-shifted image (padded row =
    image row + bh // 2, out-of-image rows zero); ``mappings`` is the full
    [nby, nbx, 256] grid. Returns the blended uint8 band (the same rows).
    The band's row 0 is image row ty0 * bh - bh // 2, which is the blend
    kernel's row origin: the kernel is the whole-image blend's.
    """
    g = _image(band, device)
    bh, bw = blockshape
    if g.ndim != 2 or g.shape[1] != w or g.shape[0] % bh:
        raise ValueError(f"band {tuple(g.shape)} is not [k * {bh}, {w}]")
    m = as_tensor(mappings, g.device).to(torch.float32)
    if m.ndim != 3 or m.shape[-1] != 256:
        raise ValueError(f"mappings must be [nby, nbx, 256], got {tuple(m.shape)}")
    y0 = ty0 * bh - bh // 2
    return klocaleq.blend_blocks_kernel(g[None], m[None].contiguous(), tuple(blockshape), y0)[0]


def histeq_local_block(
    gray,
    alpha: float = 0.5,
    punch: float = 0.05,
    clip: float = 3.0,
    blockshape: Tuple[int, int] = (256, 256),
    clahe_clip: float = 0.0,
    *,
    device=None,
) -> torch.Tensor:
    """Local-block (CLAHE-style) histeq of uint8 [H, W] or [B, H, W]
    (defaults of eq_local_block.py:10): block histograms -> block LUTs ->
    bilinear 4-LUT blend. Any block shape that divides the image."""
    g3, single = _luma(gray, device, "histeq_local_block")
    out = _histeq_local_batched(g3, alpha, punch, clip, tuple(blockshape), clahe_clip)
    return out[0] if single else out


def _histeq_local_batched(
    g3: torch.Tensor,
    alpha: float,
    punch: float,
    clip: float,
    blockshape: Tuple[int, int],
    clahe_clip: float,
    stages: Stages = KERNEL_STAGES,
) -> torch.Tensor:
    """[B, H, W] uint8 -> [B, H, W] uint8 through ``stages``."""
    m4 = _block_mappings_batched(g3, alpha, punch, clip, blockshape, clahe_clip, stages)
    return stages.blend(g3, m4, blockshape)
