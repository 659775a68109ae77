"""Dense optical flow of VGA frame pairs: the program's hybrid block-matching
pyramid (``ops.motion.estimate_motion_pyramid`` with method 'fast', a 9 x 9
median and 12 subpixel rounds), its plain reference
(``reference/motion.py``) and the counts. The outputs compared are the
finest flow and every coarser level's flow."""

from __future__ import annotations

import torch

from benchmark_torch.common import counts as cnt
from benchmark_torch.common.roofline import OPS_PER_ELEM
from benchmark_torch.reference import motion as ref_motion

REF_BLOCK = 2  # pairs per block of the reference
CONTROL = {"fit_dtype": torch.bfloat16, "upscale_dtype": torch.bfloat16}
TOLERANCE_PX = 0.01  # a flow vector is off when its end point lies farther from the reference's
FLOW = 2 * cnt.F32  # bytes of one flow vector
PLANES = 2  # a pair's frames, and a flow's planes


def build(spec: dict, device):
    from oclcomputervision_tpu_torch.ops import motion

    def entry(x):  # uint8 [B, 2, H, W]
        # looked up at each call, so that ``plant`` can route its output
        return motion.estimate_motion_pyramid(
            x[:, 0], x[:, 1], spec["levels"], spec["search_size"], spec["patch_size"],
            seed_mode=spec["seed_mode"], method=spec["method"], smooth=spec["smooth"],
            subpixel=spec["subpixel"])
    return entry


def flatten(out) -> list:
    return [out[-1], *out[:-1]]


def _flows(spec: dict, x: torch.Tensor, **precision) -> list:
    """The reference's flows of uint8 [B, 2, H, W] ``x``, coarsest first,
    in blocks of pairs."""
    blocks = [ref_motion.hybrid(x[i : i + REF_BLOCK], spec, **precision)
              for i in range(0, x.shape[0], REF_BLOCK)]
    return [torch.cat(parts) for parts in zip(*blocks)]


def reference(spec: dict, x: torch.Tensor, **precision) -> list:
    """The plain reference of uint8 [B, 2, H, W] ``x``, as ``flatten`` orders it."""
    return flatten(_flows(spec, x, **precision))


def control(spec: dict, device):
    """The reference in the precision below the stated one, in the program's
    place, on a batch."""
    return lambda x: _flows(spec, x, **CONTROL)


def plant(monkeypatch, broken) -> None:
    """Route the program's finest flow through ``broken`` where it is
    produced: ``ops.motion.estimate_motion_pyramid``, which the entry
    ``build`` returns calls."""
    from oclcomputervision_tpu_torch.ops import motion

    pyramid = motion.estimate_motion_pyramid

    def estimate(*args, **kwargs):
        flows = pyramid(*args, **kwargs)
        return [*flows[:-1], broken(flows[-1])]

    monkeypatch.setattr(motion, "estimate_motion_pyramid", estimate)


def out_pixels(spec: dict, frame_hw) -> int:
    return frame_hw[0] * frame_hw[1]  # one flow vector per pixel of a pair


def level_shapes(spec: dict, frame_hw) -> list:
    """[(h, w)] of the pyramid's levels, coarsest first."""
    h, w = frame_hw
    return [(h >> k, w >> k) for k in reversed(range(spec["levels"]))]


def kernel_counts(spec: dict, batch: int, frame_hw) -> dict:
    """{kernel: (bytes, operations)} of one call, as ``chip_smoke.py``
    counts each launch (phase 6's motion bounds): the coarsest level runs
    the unseeded exact search, every later level the fast iteration (one
    round and one median launch per step) and one seeded exact search."""
    n = len(ref_motion.steps(spec["search_size"], spec["patch_size"]))
    out = {"me_exact": [0, 0], "me_fast_round": [0, 0], "me_fast_median": [0, 0]}

    def add(kernel, moved, ops):
        out[kernel][0] += moved
        out[kernel][1] += ops

    for lv, (h, w) in enumerate(level_shapes(spec, frame_hw)):
        px = batch * h * w
        # both uint8 frames read, the seed read where there is one, the flow written
        add("me_exact", PLANES * px * cnt.U8 + (2 if lv else 1) * px * FLOW,
            OPS_PER_ELEM["me_exact"] * px)
        if lv:
            # per round both frames read, the int32 state pair read (none in the
            # first round) and the moved state pair written
            add("me_fast_round", n * PLANES * px * cnt.U8 + (2 * n - 1) * px * 2 * cnt.I32,
                OPS_PER_ELEM["me_fast_round"] * n * px)
            # per round a state pair read and a state pair (or the flow) written
            add("me_fast_median", 2 * n * px * 2 * cnt.I32, OPS_PER_ELEM["me_fast_median"] * n * px)
    return {k: tuple(v) for k, v in out.items()}


def subpixel_ops(patch: int) -> int:
    """Operations per flow vector of one subpixel fit: 5 costs of a gathered
    difference, its absolute value and 2 (patch - 1) sums of the separable
    patch sum; per axis the fit's 11 (a difference, a max, a difference, a
    product, a clamp, a division, two compares, an and, a select, a clamp)
    and the sum with the rounded flow; the 2 roundings."""
    return 5 * (2 + 2 * (patch - 1)) + 2 * (11 + 1) + 2


def counts(spec: dict, batch: int, frame_hw) -> dict:
    kernels = kernel_counts(spec, batch, frame_hw)
    levels = level_shapes(spec, frame_hw)
    k2 = spec["smooth"] ** 2
    ops = sum(o for _, o in kernels.values())
    for lv, (h, w) in enumerate(levels):
        px = batch * h * w
        # the 9 x 9 medians (after each subpixel fit, and the refinement's on a
        # later level): k^2 compares per output element per plane
        ops += (spec["subpixel"] + (1 if lv else 0)) * PLANES * px * k2
        ops += spec["subpixel"] * subpixel_ops(spec["patch_size"]) * px
        if lv + 1 < len(levels):
            # the x 2 seed upscale of both planes: 2 products and a sum down the
            # rows, the same along the columns, then the scale
            ops += PLANES * batch * (3 * 2 * h * w + 3 * 4 * h * w + 4 * h * w)
    # the pyramids of both frames: each coarser level made from the next finer one
    ops += sum(cnt.pyr_down_call(PLANES * batch, h, w)[1] for h, w in levels[1:])
    # bytes of the whole call: both frames in, every level's flow out, once
    moved = batch * PLANES * frame_hw[0] * frame_hw[1] * cnt.U8
    moved += sum(batch * h * w * FLOW for h, w in levels)
    return {"call": (moved, ops), "kernels": kernels}


def compare(spec: dict, program: list, reference: list) -> dict:
    """The share of flow vectors, over every level, whose end point lies
    more than ``TOLERANCE_PX`` from the reference's (a missing, misshapen
    or NaN output counts as off)."""
    if len(program) != len(reference):
        return {"flow_off_share": 1.0}
    off = total = 0
    for p, r in zip(program, reference):
        p = p.to(r.device)
        if tuple(p.shape) != tuple(r.shape) or p.dtype != r.dtype:
            return {"flow_off_share": 1.0}
        near = ((p - r) ** 2).sum(-1) <= TOLERANCE_PX**2
        off += int((~near).sum().item())
        total += near.numel()
    return {"flow_off_share": off / total}
