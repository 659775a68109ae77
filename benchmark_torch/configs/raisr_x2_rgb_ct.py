"""Colour RAISR x2 with the census-transform blend: the program's
``RaisrModel.upsample`` with ``blend='ct'`` on RGB frames, its plain
reference (``reference/raisr_colour.py``) and the counts. The shipped x2
bank and model are ``raisr_x2``'s."""

from __future__ import annotations

import torch

from benchmark_torch.common import checks, counts as cnt
from benchmark_torch.configs import raisr_x2  # the shared RAISR model, bank and fault site
from benchmark_torch.reference import raisr as ref_raisr
from benchmark_torch.reference import raisr_colour as ref_colour

REF_BLOCK = 4  # images per block of the reference
CONTROL = {"stage_dtype": torch.bfloat16, "apply_dtype": torch.float8_e4m3fn}
CHANNELS = 3
CSC_OPS = 3 * (3 + 2)  # per pixel and direction: 3 rows of 3 products and 2 sums
# per HR pixel: 8 compares with the centre, 8 changes around the ring, 7
# sums, the weight (8 - LCC) / 6 and its clip (3)
CT_OPS = 8 + 8 + 7 + 3
BLEND_OPS = 4  # per pixel and channel: w f, 1 - w, its product, the sum

build = raisr_x2.build
plant = raisr_x2.plant


def flatten(out) -> list:
    return [out]


def reference(spec: dict, x: torch.Tensor, **precision) -> list:
    """The plain reference of uint8 [B, H, W, 3] ``x``, in blocks of images."""
    bank, _ = ref_raisr.load_bank(raisr_x2.bank_path(spec))
    outs = [ref_colour.upsample(x[i : i + REF_BLOCK], bank, spec["raisr"], **precision)
            for i in range(0, x.shape[0], REF_BLOCK)]
    return [torch.cat(outs)]


def control(spec: dict, device):
    """The reference in the precision below the stated one, in the program's
    place, on a batch."""
    return lambda x: reference(spec, x, **CONTROL)[0]


def out_pixels(spec: dict, frame_hw) -> int:
    """Output pixels of a frame (each of three samples)."""
    return raisr_x2.out_pixels(spec, frame_hw)


def kernel_counts(r: dict, batch: int, h: int, w: int) -> dict:
    """{kernel: (bytes, operations)} of a colour call: the upscale of the
    three channels' planes as one stacked batch, the hash of Y's planes, and
    the apply of Y, U and V's planes with Y's buckets (read once) and the
    bank (read once)."""
    gray = cnt.raisr_stages(r, batch, h, w)
    stacked = cnt.raisr_stages(r, CHANNELS * batch, h, w)
    s = r["scale"]
    h2p, w2p, _, hq, wq = cnt.plane_geometry(h, w, r)
    planes = batch * s * s * hq * wq * cnt.F32
    buckets = batch * s * s * h2p * w2p * cnt.I32
    filtered = batch * s * s * h2p * w2p * cnt.F32
    nf = r["num_angle"] * r["num_strength"] * r["num_coherence"] * s * s
    bank = nf * r["filter_len"] ** 2 * cnt.F32
    return {
        "upscale_planes": stacked["upscale_planes"],
        "raisr_hash": gray["raisr_hash"],
        "raisr_apply": (CHANNELS * (planes + filtered) + buckets + bank,
                        CHANNELS * gray["raisr_apply"][1]),
    }


def counts(spec: dict, batch: int, frame_hw) -> dict:
    """The kernels' counts and the whole call's: RGB uint8 in and out once
    and the bank; the kernels' operations, both colour conversions, the
    census weights, the blend of three channels and the quantisation of
    three samples an output pixel."""
    r, (h, w) = spec["raisr"], frame_hw
    kernels = kernel_counts(r, batch, h, w)
    s = r["scale"]
    hr = batch * s * s * h * w
    nf = r["num_angle"] * r["num_strength"] * r["num_coherence"] * s * s
    moved = CHANNELS * (batch * h * w + hr) * cnt.U8 + nf * r["filter_len"] ** 2 * cnt.F32
    ops = sum(o for _, o in kernels.values())
    ops += (2 * CSC_OPS + CT_OPS + CHANNELS * (BLEND_OPS + cnt.QUANTIZE_OPS)) * hr
    return {"call": (moved, ops), "kernels": kernels}


def compare(spec: dict, program: list, reference: list) -> dict:
    return {"off_gt1_share": checks.off_gt1_share(program, reference)}
