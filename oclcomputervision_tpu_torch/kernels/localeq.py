"""Local-block histogram equalization kernels: tile histograms and the
4-LUT bilinear blend.

Ports of ``oclcomputervision_tpu/ops/pallas/localeq_pallas.py``:

- ``hist_tiles`` (plain) / ``hist_tiles_kernel`` (wrapper over
  ``csrc/hist_tiles.cu``) replace ``hist_tiles_pallas``: [B, H, W] uint8 ->
  [B, H/th, W/tw, 256] float32 exact counts for any tile (th, tw) that
  divides the image. The TPU path histograms half-block quadrants and sums
  four of them per block; the port histograms the blocks directly.
- ``blend_blocks`` (plain) / ``blend_blocks_kernel`` (``csrc/blend_blocks.cu``)
  replace both ``_blend_blocks`` (images the blocks divide) and
  ``_blend_tiles`` (``apply_block_mappings_pallas``: caller-given mappings on
  any geometry): [B, H, W] uint8 and a float32 LUT grid [B, nby, nbx, 256]
  -> [B, H, W] uint8, the XLA twin ``ops/histeq.apply_block_mappings``'s
  arithmetic in its order. The TPU kernels' int8 LUT split is TPU numerics
  and is not carried over: the kernel equals the plain version bit for bit.

Each wrapper takes the plain version for a CPU tensor and launches its
kernel for a CUDA tensor.
"""

from __future__ import annotations

import torch

from oclcomputervision_tpu_torch.kernels._build import launch, require_cuda_tensor
from oclcomputervision_tpu_torch.kernels.histeq import MAX_GRID_YZ, hist256

BLOCK_PIXELS = 16384  # pixels one CUDA block of hist_tiles takes of a tile, at most
# pixels one CUDA block of blend_blocks takes of a padded tile, at most: it
# stages a 32 KB table first
BLEND_BLOCK_PIXELS = 32768


def _check_tile(shape, tile) -> None:
    """Raise unless the tile (th, tw) divides the image [..., H, W]."""
    th, tw = tile
    h, w = shape[-2:]
    if th < 1 or tw < 1 or h % th or w % tw:
        raise ValueError(f"image {tuple(shape)} not divisible by tile {tuple(tile)}")


def _check_blend_geometry(h: int, w: int, nby: int, nbx: int, blockshape, y0: int = 0) -> None:
    """Raise unless an [H, W] band whose row 0 is image row ``y0`` fits the
    half-block-shifted LUT grid (the XLA twin's padding: -bh/2 <= y0 and
    y0 + H <= (nby + 1) bh - bh/2, likewise W from column 0)."""
    bh, bw = blockshape
    if nby < 1 or nbx < 1 or bh < 1 or bw < 1:
        raise ValueError(f"empty LUT grid {nby}x{nbx} or block {tuple(blockshape)}")
    if y0 < -(bh // 2):
        raise ValueError(f"band row 0 at image row {y0} lies above the padded grid (min {-(bh // 2)})")
    if y0 + h > (nby + 1) * bh - bh // 2 or w > (nbx + 1) * bw - bw // 2:
        raise ValueError(
            f"image {y0 + h}x{w} exceeds the {nby}x{nbx} LUT grid of {bh}x{bw} blocks "
            f"(at most {(nby + 1) * bh - bh // 2}x{(nbx + 1) * bw - bw // 2})"
        )


def _rows_per_block(th: int, tw: int, pixels: int = BLOCK_PIXELS) -> int:
    return max(1, min(th, pixels // tw))


def hist_tiles(g3: torch.Tensor, tile) -> torch.Tensor:
    """Plain version: [B, H, W] uint8 -> [B, H/th, W/tw, 256] float32."""
    _check_tile(g3.shape, tile)
    b, h, w = g3.shape
    th, tw = tile
    rows = (
        g3.reshape(b, h // th, th, w // tw, tw)
        .permute(0, 1, 3, 2, 4)
        .reshape(-1, th * tw)
    )
    return hist256(rows).reshape(b, h // th, w // tw, 256)


def hist_tiles_kernel(g3: torch.Tensor, tile) -> torch.Tensor:
    """Wrapper: the plain version for a CPU tensor, the CUDA kernel for a
    CUDA tensor (contiguous [B, H, W] uint8)."""
    if g3.device.type == "cpu":
        return hist_tiles(g3, tile)
    require_cuda_tensor(g3, "g3", torch.uint8, 3)
    _check_tile(g3.shape, tile)
    b, h, w = g3.shape
    th, tw = tile
    rpb = _rows_per_block(th, tw)
    nsplit = -(-th // rpb)
    if b > MAX_GRID_YZ or (h // th) * nsplit > MAX_GRID_YZ:
        raise ValueError(f"grid too large: images={b}, tile rows x splits={(h // th) * nsplit}")
    counts = torch.empty((b, h // th, w // tw, 256), dtype=torch.int32, device=g3.device)
    launch(
        "hist_tiles", "ocvk_hist_tiles", g3.device,
        g3.data_ptr(), counts.data_ptr(), b, h, w, th, tw, rpb,
    )
    return counts.float()


def _axis(n: int, nb: int, blk: int, device, origin: int = 0):
    """Per pixel of one axis whose index 0 is image index ``origin``: the
    lower and upper corner LUT indices and the in-tile ramp, for the grid
    shifted by half a block."""
    p = torch.arange(n, device=device) + (origin + blk // 2)
    k = torch.div(p, blk, rounding_mode="floor")
    # a true division: on CUDA, dividing by a Python scalar multiplies by
    # its reciprocal instead, which can differ in the last bit
    ramp = (p - k * blk).to(torch.float32) / torch.tensor(
        float(blk), dtype=torch.float32, device=device
    )
    return (k - 1).clamp(0, nb - 1), k.clamp(0, nb - 1), ramp


def blend_blocks(g3: torch.Tensor, m4: torch.Tensor, blockshape, y0: int = 0) -> torch.Tensor:
    """Plain version: [B, H, W] uint8, LUT grid [B, nby, nbx, 256] float32
    -> [B, H, W] uint8. Row 0 of ``g3`` is image row ``y0`` of the grid's
    image (a row band of it; 0 for the whole image)."""
    b, h, w = g3.shape
    nby, nbx = m4.shape[1:3]
    bh, bw = blockshape
    _check_blend_geometry(h, w, nby, nbx, blockshape, y0)
    dev = g3.device
    iy0, iy1, t = _axis(h, nby, bh, dev, y0)
    ix0, ix1, s = _axis(w, nbx, bw, dev)
    flat = m4.reshape(-1)
    base = torch.arange(b, device=dev)[:, None, None] * (nby * nbx * 256) + g3.long()

    def corner(iy, ix):
        return flat[base + (iy[:, None] * nbx + ix[None, :]) * 256]

    v00, v01 = corner(iy0, ix0), corner(iy0, ix1)
    v10, v11 = corner(iy1, ix0), corner(iy1, ix1)
    t = t[:, None]
    out = (1 - s) * (1 - t) * v00 + s * (1 - t) * v01 + (1 - s) * t * v10 + s * t * v11
    return torch.clamp(out, 0.0, 255.0).to(torch.uint8)


def blend_tile_rows(h: int, bh: int, y0: int = 0) -> int:
    """How many padded tile rows an H-row band from image row ``y0``
    touches: the blend kernel's grid rows, a split each."""
    return (y0 + h - 1 + bh // 2) // bh - (y0 + bh // 2) // bh + 1


def blend_blocks_kernel(
    g3: torch.Tensor, m4: torch.Tensor, blockshape, y0: int = 0
) -> torch.Tensor:
    """Wrapper: the plain version for a CPU tensor, the CUDA kernel for a
    CUDA tensor (contiguous [B, H, W] uint8, [B, nby, nbx, 256] float32)."""
    if g3.device.type == "cpu":
        return blend_blocks(g3, m4, blockshape, y0)
    require_cuda_tensor(g3, "g3", torch.uint8, 3)
    require_cuda_tensor(m4, "m4", torch.float32, 4)
    b, h, w = g3.shape
    nby, nbx = m4.shape[1:3]
    if m4.shape[0] != b or m4.shape[3] != 256 or m4.device != g3.device:
        raise ValueError(f"m4 must be [{b}, nby, nbx, 256] on {g3.device}, got {tuple(m4.shape)}")
    bh, bw = blockshape
    _check_blend_geometry(h, w, nby, nbx, blockshape, y0)
    rpb = _rows_per_block(bh, bw, BLEND_BLOCK_PIXELS)
    rows = blend_tile_rows(h, bh, y0) * -(-bh // rpb)
    if b > MAX_GRID_YZ or rows > MAX_GRID_YZ:
        raise ValueError(f"grid too large: images={b}, tile rows x splits={rows}")
    out = torch.empty_like(g3)
    launch(
        "blend_blocks", "ocvk_blend_blocks", g3.device,
        g3.data_ptr(), m4.data_ptr(), out.data_ptr(), b, h, w, y0, nby, nbx, bh, bw, rpb,
    )
    return out
