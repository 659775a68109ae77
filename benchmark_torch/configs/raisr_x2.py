"""RAISR x2 with the shipped bank: the program's ``RaisrModel.upsample``,
its plain reference (``reference/raisr.py``) and the counts."""

from __future__ import annotations

import os

import torch

from benchmark_torch.common import checks, counts as cnt
from benchmark_torch.reference import raisr as ref_raisr

HERE = os.path.dirname(os.path.abspath(__file__))
REF_BLOCK = 4  # images per block of the reference
CONTROL = {"stage_dtype": torch.bfloat16, "apply_dtype": torch.float8_e4m3fn}


def bank_path(spec: dict) -> str:
    return os.path.join(HERE, spec["bank"])


def load_model(spec: dict, device):
    """The program's model, checked to run the configuration as stated."""
    from oclcomputervision_tpu_torch.models import RaisrModel

    r = spec["raisr"]
    model = RaisrModel.load(bank_path(spec), fidelity=r["fidelity"], blend=r["blend"],
                            device=device)
    got = {k: getattr(model.cfg, k) for k in r}
    got = {k: list(v) if isinstance(v, tuple) else v for k, v in got.items()}
    if got != r:
        raise ValueError(f"the program's RaisrConfig {got} is not the configuration's {r}")
    return model


def build(spec: dict, device):
    return load_model(spec, device).upsample


def flatten(out) -> list:
    return [out]


def reference(spec: dict, x: torch.Tensor, **precision) -> list:
    """The plain reference of uint8 [B, H, W] ``x``, in blocks of images."""
    bank, _ = ref_raisr.load_bank(bank_path(spec))
    outs = [ref_raisr.upsample(x[i : i + REF_BLOCK], bank, spec["raisr"], **precision)
            for i in range(0, x.shape[0], REF_BLOCK)]
    return [torch.cat(outs)]


def control(spec: dict, device):
    """The reference in the precision below the stated one, in the program's
    place, on a batch."""
    return lambda x: reference(spec, x, **CONTROL)[0]


def plant(monkeypatch, broken) -> None:
    """Route the program's output through ``broken`` where it is produced:
    ``RaisrModel.upsample``, the entry ``build`` returns."""
    from oclcomputervision_tpu_torch.models import RaisrModel

    upsample = RaisrModel.upsample
    monkeypatch.setattr(RaisrModel, "upsample", lambda self, x: broken(upsample(self, x)))


def out_pixels(spec: dict, frame_hw) -> int:
    s = spec["raisr"]["scale"]
    return s * frame_hw[0] * s * frame_hw[1]


def counts(spec: dict, batch: int, frame_hw) -> dict:
    h, w = frame_hw
    return {"call": cnt.raisr_call(spec["raisr"], batch, h, w),
            "kernels": cnt.raisr_stages(spec["raisr"], batch, h, w)}


def compare(spec: dict, program: list, reference: list) -> dict:
    return {"off_gt1_share": checks.off_gt1_share(program, reference)}
