#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's RAISR x2 inference once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Run from the repository root on a machine with one CUDA card. Phases (any
failure raises, and the script exits non-zero without the result line):

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. build the hand-written kernels from ``kernels/csrc`` with nvcc;
3. each kernel against its plain PyTorch version on the card, at the bench
   geometry (1024x1024 LR -> 2048x2048 HR, x2) with a batch of 2, and with
   the x3 and x4 banks on one 256x256 image;
4. the slice end to end through ``RaisrModel.load(...).upsample``: a
   16x1024x1024 uint8 batch (each kernel's launch count must rise during
   it) and one RGB image (lenna 512^2 -> 1024^2, held against the plain
   path);
5. quality on held-out frame11: RAISR PSNR above bilinear, and above 35 dB
   against the numpy oracle;
6. timing with CUDA events (median of 5 after 2 warm-ups): output MP/s of
   the 16x1024^2 batch through the kernels and through the plain versions,
   a torch.profiler breakdown of the kernel path (device ms per kernel and
   the idle share), and each kernel's and plain version's time at the
   batch's shapes.

Prints the per-kernel JSON line, then, as its last line,
``{"ok": true, "device": {...}}``. Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

UPSCALE_TOL = 1.2e-7  # <= 1 f32 ULP on [0, 1] (tests/test_pallas.py:305's bound)
HASH_AGREEMENT = 0.9999  # bucket agreement (tests/test_pallas.py:335's contract)
APPLY_TOL = 2e-5  # bf16 x bf16 products are exact: only summation order differs
ORACLE_PSNR = 35.0  # dB, the bound of tests/test_raisr.py:80
E2E_WITHIN_ONE = 0.999  # share of output pixels within one level, kernels vs plain
LR = 1024  # bench geometry: 1024^2 LR -> 2048^2 HR at x2
BATCH = 16

KERNELS = {
    # name -> (source, replaced TPU kernel: file:line of its pl.pallas_call)
    "upscale_planes": (
        "oclcomputervision_tpu_torch/kernels/csrc/upscale_planes.cu",
        "oclcomputervision_tpu/ops/pallas/upscale_pallas.py:109",
    ),
    "raisr_hash": (
        "oclcomputervision_tpu_torch/kernels/csrc/raisr_hash.cu",
        "oclcomputervision_tpu/ops/pallas/raisr_pallas.py:826",
    ),
    "raisr_apply": (
        "oclcomputervision_tpu_torch/kernels/csrc/raisr_apply.cu",
        "oclcomputervision_tpu/ops/pallas/raisr_pallas.py:385",
    ),
}


def lenna_batch(rng, n: int, size: int):
    """bench.py's RAISR input: lenna luma tiled to size^2, then per image a
    random roll and additive noise in [-8, 8]."""
    import numpy as np

    from oclcomputervision_tpu_torch.utils import load_gray

    base = load_gray("lenna.png")
    reps = -(-size // base.shape[0]), -(-size // base.shape[1])
    tile = np.tile(base, reps)[:size, :size]
    out = []
    for _ in range(n):
        sh = rng.integers(0, 512, 2)
        noisy = tile.astype(np.int16) + rng.integers(-8, 9, tile.shape)
        out.append(np.clip(np.roll(noisy, sh, (0, 1)), 0, 255).astype(np.uint8))
    return np.stack(out)


def kernel_vs_plain(model, imgs, device):
    """Phase 3: each kernel and its plain version on the same inputs."""
    import torch

    from oclcomputervision_tpu_torch.kernels import raisr as kr
    from oclcomputervision_tpu_torch.kernels import upscale as ku
    from oclcomputervision_tpu_torch.ops.raisr import plane_geometry

    cfg = model.cfg
    x = torch.from_numpy(imgs).to(device)
    geo = plane_geometry(x.shape[1], x.shape[2], cfg)
    x01 = x.float() / torch.tensor(255.0, device=device)

    up_k = ku.upscale_planes_kernel(x01, cfg, geo.hq, geo.wq, geo.hp)
    up_p = ku.upscale_planes(x01, cfg, geo.hq, geo.wq, geo.hp)
    up_err = (up_k - up_p).abs().max().item()

    hb_k = kr.hash_planes_kernel(up_k, cfg, geo.hp, geo.h2p, geo.w2p)
    hb_p = kr.hash_planes(up_k, cfg, geo.hp, geo.h2p, geo.w2p)
    agree = (hb_k == hb_p).float().mean().item()
    hash_err = (hb_k - hb_p).abs().max().item()

    # two channels stacked over one bucket map, as the colour path runs it
    planes = torch.cat([up_k, 0.5 * up_k]).contiguous()
    ap_k = kr.apply_filters_planes_kernel(planes, hb_k, model.filters, cfg)
    ap_p = kr.apply_filters_planes(planes, hb_k, model.filters, cfg)
    torch.cuda.synchronize()
    ap_err = (ap_k - ap_p).abs().max().item()

    tag = f"x{cfg.scale} {tuple(imgs.shape)}"
    print(f"{tag} upscale_planes: max|kernel - plain| = {up_err:.3e} "
          f"(tol {UPSCALE_TOL:.1e})")
    print(f"{tag} raisr_hash: bucket agreement = {agree:.7f} "
          f"(min {HASH_AGREEMENT}), max|diff| = {hash_err}")
    print(f"{tag} raisr_apply: max|kernel - plain| = {ap_err:.3e} (tol {APPLY_TOL:.1e})")
    if not up_err <= UPSCALE_TOL:
        raise AssertionError(f"upscale kernel off by {up_err}")
    if not agree >= HASH_AGREEMENT:
        raise AssertionError(f"hash kernel agreement {agree}")
    if not ap_err <= APPLY_TOL:
        raise AssertionError(f"apply kernel off by {ap_err}")
    return {
        "upscale_planes": {"max_abs_err": up_err},
        "raisr_hash": {"max_abs_err": hash_err, "agreement": agree},
        "raisr_apply": {"max_abs_err": ap_err},
    }


def main_path(model, batch, rgb, device):
    """Phase 4: the slice through the model, counting kernel launches."""
    import torch

    from oclcomputervision_tpu_torch.kernels import _build
    from oclcomputervision_tpu_torch.ops.raisr import PLAIN_STAGES, _raisr_planes_batched

    s = model.cfg.scale
    x = torch.from_numpy(batch).to(device)
    torch.cuda.synchronize()
    _build.reset_launches()
    out = model.upsample(x)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    n, h, w = batch.shape
    if tuple(out.shape) != (n, s * h, s * w) or out.dtype != torch.uint8:
        raise AssertionError(f"batch output {tuple(out.shape)} {out.dtype}")
    print(f"main path: {tuple(batch.shape)} uint8 -> {tuple(out.shape)} uint8, "
          f"launches {launches}")
    missing = [k for k, v in launches.items() if v < 1]
    if missing:
        raise AssertionError(f"main path launched no {missing} kernel")

    rgb_t = torch.from_numpy(rgb).to(device)
    out_rgb = model.upsample(rgb_t)
    want = (s * rgb.shape[0], s * rgb.shape[1], 3)
    if tuple(out_rgb.shape) != want or out_rgb.dtype != torch.uint8:
        raise AssertionError(f"RGB output {tuple(out_rgb.shape)} {out_rgb.dtype}")
    plain = _raisr_planes_batched(rgb_t[None], model.filters, model.cfg, 3, PLAIN_STAGES)[0]
    within = ((plain.int() - out_rgb.int()).abs() <= 1).float().mean().item()
    print(f"RGB: {rgb.shape} uint8 -> {tuple(out_rgb.shape)} uint8, {within:.7f} of "
          f"values within one level of the plain path (min {E2E_WITHIN_ONE})")
    if not within >= E2E_WITHIN_ONE:
        raise AssertionError(f"RGB kernel and plain paths disagree: {within}")
    return out, launches


def quality(model):
    """Phase 5: held-out frame11 and the numpy oracle."""
    import numpy as np

    from oclcomputervision_tpu_torch.ops.raisr import oracle_raisr
    from oclcomputervision_tpu_torch.utils import load_gray, psnr

    hr = load_gray("frame11.png")
    h, w = hr.shape[0] // 2 * 2, hr.shape[1] // 2 * 2
    hr = hr[:h, :w]
    lr = hr.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3)).round().astype(np.uint8)
    sr = model.upsample(lr).cpu().numpy()
    bil = oracle_raisr.cheap_upscale(lr.astype(np.float64) / 255.0, 2)
    bil = np.clip(np.rint(bil * 255.0), 0, 255).astype(np.uint8)
    p_sr, p_bil = psnr(sr, hr), psnr(bil, hr)
    ref = oracle_raisr.raisr_upsample(
        lr, model.filters.cpu().numpy().astype(np.float64), model.cfg
    )
    p_or = psnr(sr, ref)
    print(f"frame11 x2: RAISR {p_sr:.4f} dB, bilinear {p_bil:.4f} dB; "
          f"port vs numpy oracle {p_or:.4f} dB (min {ORACLE_PSNR})")
    if not p_sr > p_bil:
        raise AssertionError("RAISR does not beat bilinear on frame11")
    if not p_or > ORACLE_PSNR:
        raise AssertionError(f"port vs oracle {p_or} dB")
    return {"raisr_db": p_sr, "bilinear_db": p_bil, "vs_oracle_db": p_or}


def timing(model, batch, out_kernel, card, device):
    """Phase 6: end-to-end and per-kernel device times at the batch's shapes."""
    import torch

    from oclcomputervision_tpu_torch.kernels import raisr as kr
    from oclcomputervision_tpu_torch.kernels import upscale as ku
    from oclcomputervision_tpu_torch.ops.raisr import (
        PLAIN_STAGES,
        _raisr_planes_batched,
        plane_geometry,
    )
    from oclcomputervision_tpu_torch.utils import cuda_time_ms, device_profile

    cfg = model.cfg
    x = torch.from_numpy(batch).to(device)
    mp_out = x.numel() * cfg.scale**2 / 1e6
    shape = "x".join(str(d) for d in batch.shape)

    out_plain = _raisr_planes_batched(x, model.filters, cfg, 1, PLAIN_STAGES)
    diff = (out_plain.int() - out_kernel.int()).abs()
    within = (diff <= 1).float().mean().item()
    print(f"kernel path vs plain path, {tuple(batch.shape)}: {within:.7f} of pixels within one "
          f"level (min {E2E_WITHIN_ONE}), max diff {diff.max().item()}")
    if not within >= E2E_WITHIN_ONE:
        raise AssertionError(f"kernel and plain paths disagree: {within}")
    del out_plain, diff

    ms_k = cuda_time_ms(model.upsample, x)
    ms_p = cuda_time_ms(_raisr_planes_batched, x, model.filters, cfg, 1, PLAIN_STAGES)
    print(f"[{card}] e2e RAISR x2 {shape} uint8 kernels: {ms_k:.4f} ms, "
          f"{mp_out / ms_k * 1e3:.2f} MP out/s")
    print(f"[{card}] e2e RAISR x2 {shape} uint8 plain:   {ms_p:.4f} ms, "
          f"{mp_out / ms_p * 1e3:.2f} MP out/s")

    per_kernel, idle = device_profile(model.upsample, x)
    print(f"[{card}] torch.profiler, device ms per call of the {shape} batch "
          f"(idle share {idle:.4f}):")
    for name, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1]):
        print(f"    {ms:9.4f}  {name[:90]}")

    geo = plane_geometry(x.shape[1], x.shape[2], cfg)
    x01 = x.float() / torch.tensor(255.0, device=device)
    up = ku.upscale_planes_kernel(x01, cfg, geo.hq, geo.wq, geo.hp)
    hb = kr.hash_planes_kernel(up, cfg, geo.hp, geo.h2p, geo.w2p)
    pairs = {
        "upscale_planes": (
            lambda: ku.upscale_planes_kernel(x01, cfg, geo.hq, geo.wq, geo.hp),
            lambda: ku.upscale_planes(x01, cfg, geo.hq, geo.wq, geo.hp),
        ),
        "raisr_hash": (
            lambda: kr.hash_planes_kernel(up, cfg, geo.hp, geo.h2p, geo.w2p),
            lambda: kr.hash_planes(up, cfg, geo.hp, geo.h2p, geo.w2p),
        ),
        "raisr_apply": (
            lambda: kr.apply_filters_planes_kernel(up, hb, model.filters, cfg),
            lambda: kr.apply_filters_planes(up, hb, model.filters, cfg),
        ),
    }
    times = {}
    for name, (fk, fp) in pairs.items():
        ms, pms = cuda_time_ms(fk), cuda_time_ms(fp)
        times[name] = {"ms": ms, "plain_ms": pms}
        print(f"[{card}] {name} at {shape}: kernel {ms:.4f} ms, plain {pms:.4f} ms")
    return times, {"e2e_ms": ms_k, "e2e_plain_ms": ms_p, "idle_share": idle,
                   "mp_out_per_s": mp_out / ms_k * 1e3,
                   "plain_mp_out_per_s": mp_out / ms_p * 1e3}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="input noise and rolls")
    args = ap.parse_args()

    import numpy as np
    import torch

    from oclcomputervision_tpu_torch import require_cuda
    from oclcomputervision_tpu_torch.kernels import _build
    from oclcomputervision_tpu_torch.models.raisr import RaisrModel
    from oclcomputervision_tpu_torch.utils import asset_path, load_image

    # phase 1: the card
    device = require_cuda()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")

    # phase 2: build
    t0 = time.perf_counter()
    nvcc_s = _build.build()
    _build.library()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s (nvcc {nvcc_s:.2f} s)")

    rng = np.random.default_rng(args.seed)
    model = RaisrModel.load(asset_path("raisr_filters_x2.npz"), device=device)

    # phase 3: kernels against their plain versions (x3 and x4 at a small size)
    errs = kernel_vs_plain(model, lenna_batch(rng, 2, LR), device)
    for scale in (3, 4):
        other = RaisrModel.load(asset_path(f"raisr_filters_x{scale}.npz"), device=device)
        kernel_vs_plain(other, lenna_batch(rng, 1, 256), device)

    # phase 4: the slice end to end
    batch = lenna_batch(rng, BATCH, LR)
    out, launches = main_path(model, batch, load_image("lenna.png"), device)

    # phase 5: quality
    quality(model)

    # phase 6: timing
    times, e2e = timing(model, batch, out, card, device)

    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": src,
            "replaces": replaces,
            "launches": launches[name],
            **errs[name],
            **times[name],
        }
        for name, (src, replaces) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels, "e2e": e2e, "card": card}))
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
