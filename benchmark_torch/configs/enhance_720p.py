"""720p to 1080p enhancement: the program's ``EnhancePipeline`` (global
equalize, RAISR x2 with the shipped bank, bicubic resize, a 3-level
pyramid), its plain reference and the counts. The outputs compared are the
1080p image and every coarser pyramid level (the finest is the image)."""

from __future__ import annotations

import torch

from benchmark_torch.common import checks, counts as cnt
from benchmark_torch.configs import raisr_x2  # the shared RAISR model and bank
from benchmark_torch.reference import histeq as ref_histeq
from benchmark_torch.reference import pyramid as ref_pyramid
from benchmark_torch.reference import raisr as ref_raisr
from benchmark_torch.reference import resize as ref_resize

REF_BLOCK = 4  # frames per block of the reference
CONTROL = {"stage_dtype": torch.bfloat16, "apply_dtype": torch.float8_e4m3fn}


def build(spec: dict, device):
    from oclcomputervision_tpu_torch.models import EnhanceConfig, EnhancePipeline
    from oclcomputervision_tpu_torch.utils.config import HistEqConfig

    model = raisr_x2.load_model(spec, device)
    cfg = EnhanceConfig(equalize="global", histeq=HistEqConfig(**spec["histeq"]),
                        superres="raisr", resize_to=tuple(spec["resize_to"]),
                        resize_method=spec["resize_method"],
                        pyramid_depth=spec["pyramid_depth"])
    return EnhancePipeline(cfg, raisr_model=model)


def flatten(out) -> list:
    image, levels = out
    return [image, *levels[:-1]]


def _chain(spec, x, bank, stage_dtype=torch.float32, apply_dtype=torch.bfloat16):
    h = spec["histeq"]
    eq = ref_histeq.equalize(x, h["alpha"], h["punch"], h["clip"], stage_dtype)
    sr = ref_raisr.upsample(eq, bank, spec["raisr"], stage_dtype, apply_dtype)
    image = ref_resize.bicubic(sr, spec["resize_to"], stage_dtype)
    levels = ref_pyramid.pyramid(image, spec["pyramid_depth"], stage_dtype)
    return [image, *levels[:-1]]


def reference(spec: dict, x: torch.Tensor, **precision) -> list:
    """The plain reference of uint8 [B, H, W] ``x``, in blocks of frames."""
    bank, _ = ref_raisr.load_bank(raisr_x2.bank_path(spec))
    blocks = [_chain(spec, x[i : i + REF_BLOCK], bank, **precision)
              for i in range(0, x.shape[0], REF_BLOCK)]
    return [torch.cat(parts) for parts in zip(*blocks)]


def control(spec: dict, device):
    """The reference in the precision below the stated one, in the program's
    place, on a batch."""
    def call(x):
        outs = reference(spec, x, **CONTROL)
        return outs[0], [*outs[1:], outs[0]]
    return call


def plant(monkeypatch, broken) -> None:
    """Route the program's 1080p image through ``broken`` where it is
    produced: ``EnhancePipeline.__call__``, the entry ``build`` returns (the
    image is also the pyramid's finest level)."""
    from oclcomputervision_tpu_torch.models import EnhancePipeline

    call = EnhancePipeline.__call__

    def pipeline(self, x, **kw):
        image, levels = call(self, x, **kw)
        image = broken(image)
        return image, [*levels[:-1], image]

    monkeypatch.setattr(EnhancePipeline, "__call__", pipeline)


def out_pixels(spec: dict, frame_hw) -> int:
    return spec["resize_to"][0] * spec["resize_to"][1]


def counts(spec: dict, batch: int, frame_hw) -> dict:
    h, w = frame_hw
    s = spec["raisr"]["scale"]
    ho, wo = spec["resize_to"]
    parts = [cnt.histeq_call(batch, h, w), cnt.raisr_call(spec["raisr"], batch, h, w),
             cnt.bicubic_call(batch, s * h, s * w, ho, wo)]
    for _ in range(spec["pyramid_depth"] - 1):
        parts.append(cnt.pyr_down_call(batch, ho, wo))
        ho, wo = ho // 2, wo // 2
    # bytes of the whole call: the frames in and every output out, once
    moved = batch * h * w
    ho, wo = spec["resize_to"]
    for _ in range(spec["pyramid_depth"]):
        moved += batch * ho * wo
        ho, wo = ho // 2, wo // 2
    nf = spec["raisr"]["num_angle"] * spec["raisr"]["num_strength"] * spec["raisr"]["num_coherence"] * s * s
    moved += nf * spec["raisr"]["filter_len"] ** 2 * cnt.F32
    kernels = cnt.raisr_stages(spec["raisr"], batch, h, w)
    return {"call": (moved, sum(ops for _, ops in parts)), "kernels": kernels}


def compare(spec: dict, program: list, reference: list) -> dict:
    return {"off_gt1_share": checks.off_gt1_share(program, reference)}
