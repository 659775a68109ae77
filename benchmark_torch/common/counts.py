"""Operations and bytes of the configurations' stages, counted from their
shapes: the work the algorithm needs for the inputs, not what a kernel
happens to do.

The kernels' counts follow ``chip_smoke.py`` phase 6: a kernel's bytes are
the tensors it reads once and writes once (the program's parity planes,
whose geometry ``plane_geometry`` copies from ``ops/raisr.py``), its
operations ``OPS_PER_ELEM`` per HR pixel. For a frame whose sides are
multiples of 64 x 128 the element counts equal chip_smoke's, which counts
the padded planes; for others they count only the image's pixels.
"""

from __future__ import annotations

from benchmark_torch.common.roofline import OPS_PER_ELEM, hash_ops

TILE_H, LANE, HALO_ROWS = 64, 128, 8  # ops/raisr.py: plane rows and columns, halo rows
F32, I32, U8 = 4, 4, 1
QUANTIZE_OPS = 3  # scale by 255, round, clamp per output pixel


def plane_halo(fl: int, s: int, gauss_len: int) -> int:
    return max(-(-(fl // 2) // s), -(-(gauss_len // 2) // s) + 1)


def plane_geometry(h: int, w: int, r: dict):
    """(h2p, w2p, hp, hq, wq) of an h x w LR image (``ops.raisr.plane_geometry``)."""
    h2p = -(-h // TILE_H) * TILE_H
    w2p = -(-w // LANE) * LANE
    return h2p, w2p, plane_halo(r["filter_len"], r["scale"], r["gauss_len"]), h2p + HALO_ROWS, w2p + LANE


def raisr_stages(r: dict, batch: int, h: int, w: int) -> dict:
    """{kernel: (bytes, operations)} of RAISR on ``batch`` gray h x w images."""
    s, fl = r["scale"], r["filter_len"]
    ss = s * s
    h2p, w2p, _, hq, wq = plane_geometry(h, w, r)
    hr = batch * ss * h * w
    planes = batch * ss * hq * wq * F32
    buckets = batch * ss * h2p * w2p * I32
    filtered = batch * ss * h2p * w2p * F32
    nf = r["num_angle"] * r["num_strength"] * r["num_coherence"] * ss
    bank = nf * fl * fl * F32
    return {
        "upscale_planes": (batch * h * w * F32 + planes, OPS_PER_ELEM["upscale_planes"] * hr),
        "raisr_hash": (planes + buckets, hash_ops(r["gauss_len"], len(r["strength_quantizers"]),
                                                  len(r["coherence_quantizers"])) * hr),
        "raisr_apply": (planes + buckets + bank + filtered, 2 * fl * fl * hr),
    }


def raisr_call(r: dict, batch: int, h: int, w: int):
    """(bytes, operations) of one whole RAISR call: uint8 in and out once
    and the bank; every stage's operations and the quantisation."""
    s = r["scale"]
    stages = raisr_stages(r, batch, h, w)
    hr = batch * s * s * h * w
    nf = r["num_angle"] * r["num_strength"] * r["num_coherence"] * s * s
    moved = batch * h * w * U8 + hr * U8 + nf * r["filter_len"] ** 2 * F32
    return moved, sum(ops for _, ops in stages.values()) + QUANTIZE_OPS * hr


def histeq_call(batch: int, h: int, w: int):
    """(bytes, operations): one count per pixel; the LUT apply is a load."""
    return 2 * batch * h * w * U8, OPS_PER_ELEM["hist256"] * batch * h * w


def bicubic_call(batch: int, h: int, w: int, h_out: int, w_out: int):
    """Rows then columns, 4 taps of a product and a sum, then the clamp,
    round and cast."""
    ops = 8 * batch * h_out * w + 8 * batch * h_out * w_out + QUANTIZE_OPS * batch * h_out * w_out
    return batch * (h * w + h_out * w_out) * U8, ops


def pyr_down_call(batch: int, h: int, w: int):
    """The 5-tap blur (5 products, 4 sums) down the kept rows, then along
    the kept columns, then round and clamp."""
    ho, wo = h // 2, w // 2
    return batch * (h * w + ho * wo) * U8, 9 * batch * ho * w + (9 + 2) * batch * ho * wo
