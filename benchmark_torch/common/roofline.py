"""The chip's published peaks and the roofline arithmetic.

Copied from ``chip_smoke.py`` (``HBM_BYTES_PER_S``, ``F32_OPS_PER_S``,
``OPS_PER_ELEM``, ``hash_ops``; ``least_seconds`` is ``bound``'s larger
term) so that the yardstick stays fixed when the program's own tools change. The copies must stay equal to the
originals (``benchmark_torch/tests/test_arithmetic.py``).
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W power limit
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores; used for integer ALU work too

# operations per output element, counted from each kernel's arithmetic
OPS_PER_ELEM = {
    "upscale_planes": 12,  # 2 x 2 taps: 4 products and 4 sums per pass
    "raisr_hash": 150,  # Sobel 22, tensor products 3, 9x9 blur of 3 maps 102, eigen and buckets ~23
    "raisr_apply": 2 * 121,  # one multiply and one add per tap
    "upscale_planes_generic": 12,
    "hist256": 1,  # one count per pixel
    "apply_lut": 0,  # a table load per pixel
    "hist_tiles": 1,
    "blend_blocks": 17,  # 2 ramps, 2 complements, 8 products, 3 sums, 2 clamps
    "me_exact": 25 * 25 * 3,
    "me_fast_round": 75,
    "me_fast_median": 2 * 19 * 2,
}


def least_seconds(moved: int, ops: int) -> float:
    """The least seconds the chip can take to move ``moved`` bytes once and
    do ``ops`` operations: the larger of the two bounds (``chip_smoke.bound``)."""
    return max(moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def hash_ops(gauss_len: int, n_strength_quant: int, n_coherence_quant: int) -> int:
    """Operations per HR pixel of the RAISR hash (``chip_smoke.hash_ops``):
    Sobel 22, the tensor products 3, two blur passes of 3 maps (gauss_len
    products and gauss_len - 1 sums each), the eigen analysis 19 and one
    compare per quantizer (150 at the shipped config)."""
    return 25 + 6 * (2 * gauss_len - 1) + 19 + n_strength_quant + n_coherence_quant
