#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths once on one NVIDIA GPU: RAISR x2
inference, and global and local-block histogram equalization.

    python3 chip_smoke.py [--seed 0]

Run from the repository root on a machine with one CUDA card. Phases (any
failure raises, and the script exits non-zero without the result line):

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. build the hand-written kernels from ``kernels/csrc`` with nvcc;
3. each RAISR kernel against its plain PyTorch version on the card, at the
   bench geometry (1024x1024 LR -> 2048x2048 HR, x2) with a batch of 2, and
   with the x3 and x4 banks on one 256x256 image;
3b. each histeq kernel against its plain version, which it must equal: on
   random, natural (lenna tiled, rolled, +-8 noise) and constant batches at
   bench.py's geometries (hist256 and apply_lut on 256x768x1280, hist_tiles
   and blend_blocks on 64x768x1280 at 256x256 blocks), on a 3x101x77 batch
   and on a row that starts one byte past a 16-byte boundary;
4. RAISR end to end through ``RaisrModel.load(...).upsample``: a
   16x1024x1024 uint8 batch (each RAISR kernel's launch count must rise
   during it) and one RGB image (lenna 512^2 -> 1024^2, held against the
   plain path);
4b. histeq end to end through ``ops``: ``histeq_global`` on 256x768x1280,
   ``histeq_local_block(x, 0.5, 0.05, 3.0, (256, 256))`` on 64x768x1280
   with clahe_clip 0 and 2, and ``apply_block_mappings`` on 2x880x1400 with
   a 3x5 LUT grid (blocks that do not divide the image); each path's
   kernels' launch counts must rise during it, its output must equal the
   plain path's, and one natural image is held against the numpy oracle;
5. quality on held-out frame11: RAISR PSNR above bilinear, and above 35 dB
   against the numpy oracle;
6. RAISR timing with CUDA events (median of 5 after 2 warm-ups): output
   MP/s of the 16x1024^2 batch through the kernels and through the plain
   versions, a torch.profiler breakdown of the kernel path (device ms per
   kernel and the idle share), and at the batch's shapes each kernel's own
   device time (torch.profiler), its wrapper call's and its plain version's
   time (CUDA events), and for the upscale the time of F.interpolate
   (align_corners=True), checked to give the same values;
6b. histeq timing, the same way: input MP/s of both ops through the
   kernels and the plain versions, their profiles, and each kernel's,
   plain version's and single PyTorch call's time at the bench shapes
   (each such call first checked equal to its kernel).

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
# upscale planes vs F.interpolate, which maps coordinates in f32 (src =
# scale * dst, ~1e-4 of a pixel off at 2048 wide) where the planes' weights
# come from f64: a quarter of one uint8 level (3.9e-3)
LIBRARY_UPSCALE_TOL = 1e-3
LR = 1024  # bench geometry: 1024^2 LR -> 2048^2 HR at x2
BATCH = 16
GLOBAL_SHAPE = (256, 768, 1280)  # bench.py's fused_histeq_global_throughput geometry
LOCAL_SHAPE = (64, 768, 1280)  # bench.py's histeq_local_block_throughput geometry
BLOCK = (256, 256)
# apply_block_mappings with the 3x5 LUT grid of a 768x1280 image on a larger
# image the blocks do not divide (the grid covers up to 896x1408)
MAPPED_SHAPE = (2, 880, 1400)
HISTEQ_ORACLE_SHARE = 0.01  # global vs oracle: <= 1 level on < 1 % (tests/test_histeq.py:65-72)

# bounds: the card's published rates (NVIDIA H100 SXM data sheet, 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores; used for integer ALU work too
# operations per output element, counted from each kernel's arithmetic
OPS_PER_ELEM = {
    "upscale_planes": 12,  # 2 x 2 taps: 4 products and 4 sums per pass
    "raisr_hash": 150,  # Sobel 22, tensor products 3, 9x9 blur of 3 maps 102, eigen and buckets ~23
    "raisr_apply": 2 * 121,  # one multiply and one add per tap
    "hist256": 1,  # one count per pixel
    "apply_lut": 0,  # a table load per pixel
    "hist_tiles": 1,
    "blend_blocks": 17,  # 2 ramps, 2 complements, 8 products, 3 sums, 2 clamps
}
RAISR_KERNELS = ("upscale_planes", "raisr_hash", "raisr_apply")
GLOBAL_KERNELS = ("hist256", "apply_lut")
LOCAL_KERNELS = ("hist_tiles", "blend_blocks")

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
    "hist256": (
        "oclcomputervision_tpu_torch/kernels/csrc/hist256.cu",
        "oclcomputervision_tpu/ops/pallas/histeq_pallas.py:78",
    ),
    "apply_lut": (
        "oclcomputervision_tpu_torch/kernels/csrc/apply_lut.cu",
        "oclcomputervision_tpu/ops/pallas/histeq_pallas.py:126",
    ),
    "hist_tiles": (
        "oclcomputervision_tpu_torch/kernels/csrc/hist_tiles.cu",
        "oclcomputervision_tpu/ops/pallas/localeq_pallas.py:256",
    ),
    "blend_blocks": (
        "oclcomputervision_tpu_torch/kernels/csrc/blend_blocks.cu",
        "oclcomputervision_tpu/ops/pallas/localeq_pallas.py:187 and "
        "oclcomputervision_tpu/ops/pallas/localeq_pallas.py:288",
    ),
}


def bound(name: str, moved: int, elems: int):
    """(least ms, "bytes" or "operations") for moving ``moved`` bytes once
    and doing OPS_PER_ELEM[name] operations on each of ``elems`` elements."""
    by_bytes = moved / HBM_BYTES_PER_S * 1e3
    by_ops = OPS_PER_ELEM[name] * elems / F32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def kernel_ms(name: str, fn) -> float:
    """Device ms per call of kernel ``name``'s own launches in ``fn()``, from
    torch.profiler over 5 calls after one warm-up. Unlike a CUDA-event window
    around the call, it leaves out the wrapper's host work (allocation, the
    ctypes call), which a kernel of tens of microseconds does not hide."""
    from oclcomputervision_tpu_torch.utils import device_profile

    per_kernel, _ = device_profile(fn)
    hits = [ms for k, ms in per_kernel.items() if f"{name}_kernel" in k]
    if not hits:
        raise AssertionError(f"the profiler saw no {name} kernel in {sorted(per_kernel)}")
    return sum(hits)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def lenna_batch(rng, n: int, h: int, w: int | None = None):
    """bench.py's RAISR input: lenna luma tiled to h x w (square by
    default), then per image a random roll and additive noise in [-8, 8]."""
    import numpy as np

    from oclcomputervision_tpu_torch.utils import load_gray

    w = h if w is None else w
    base = load_gray("lenna.png")
    reps = -(-h // base.shape[0]), -(-w // base.shape[1])
    tile = np.tile(base, reps)[:h, :w]
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
    missing = [k for k in RAISR_KERNELS if launches[k] < 1]
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
    ap = kr.apply_filters_planes_kernel(up, hb, model.filters, cfg)
    moved = {
        "upscale_planes": (nbytes(x01, up), up.numel()),
        "raisr_hash": (nbytes(up, hb), hb.numel()),
        "raisr_apply": (nbytes(up, hb, model.filters, ap), ap.numel()),
    }
    # the one PyTorch call with the same values: align-corners bilinear to
    # the HR image, which the parity planes hold rearranged (plane a*s+b,
    # element (i, j) is HR pixel (s*(i - hp) + a, s*(j - hp) + b)); no single
    # call computes bucket maps or the bucket-selected filter
    s, (n, h, w) = cfg.scale, x01.shape
    library = {"upscale_planes": lambda: torch.nn.functional.interpolate(
        x01[:, None], size=(s * h, s * w), mode="bilinear", align_corners=True)}
    hr = library["upscale_planes"]()[:, 0]
    inner = up[:, :, geo.hp : geo.hp + h, geo.hp : geo.hp + w]
    lib_err = (inner.reshape(n, s, s, h, w).permute(0, 3, 1, 4, 2).reshape(n, s * h, s * w)
               - hr).abs().max().item()
    print(f"upscale_planes vs F.interpolate(align_corners=True) inside the image: "
          f"max |diff| {lib_err:.3e} (tol {LIBRARY_UPSCALE_TOL:.0e})")
    if not lib_err <= LIBRARY_UPSCALE_TOL:
        raise AssertionError(f"F.interpolate is not the upscale's function: {lib_err}")
    del hr, inner
    times = {}
    for name, (fk, fp) in pairs.items():
        ms, call_ms, pms = kernel_ms(name, fk), cuda_time_ms(fk), cuda_time_ms(fp)
        lms = cuda_time_ms(library[name]) if name in library else None
        bms, by = bound(name, *moved[name])
        times[name] = {"ms": ms, "call_ms": call_ms, "plain_ms": pms, "bound_ms": bms,
                       "bound_by": by, "library_ms": lms}
        lib = "none" if lms is None else f"{lms:.4f} ms (F.interpolate, HR image)"
        print(f"[{card}] {name} at {shape}: kernel {ms:.4f} ms (whole call {call_ms:.4f} ms), "
              f"plain {pms:.4f} ms, bound {bms:.4f} ms ({by}: {moved[name][0] / 1e6:.1f} MB), "
              f"library {lib}")
    return times, {"e2e_ms": ms_k, "e2e_plain_ms": ms_p, "idle_share": idle,
                   "mp_out_per_s": mp_out / ms_k * 1e3,
                   "plain_mp_out_per_s": mp_out / ms_p * 1e3}


def histeq_batches(rng, device):
    """The histeq inputs at bench.py's global geometry: random uint8 (the
    bench's content, from the seed), natural (lenna tiled, rolled, +-8
    noise) and constant (every pixel 77: one bin, the worst case for
    atomics)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(int(rng.integers(1 << 31)))
    return {
        "random": torch.randint(0, 256, GLOBAL_SHAPE, generator=gen, device=device,
                                dtype=torch.uint8),
        "natural": torch.from_numpy(lenna_batch(rng, *GLOBAL_SHAPE)).to(device),
        "constant": torch.full(GLOBAL_SHAPE, 77, dtype=torch.uint8, device=device),
    }


def histeq_kernel_vs_plain(batches, rng, device):
    """Phase 3b: each histeq kernel and its plain version on the same
    inputs; they must be equal (counts and bytes; the blend rounds every
    product and sum in the plain version's order)."""
    import torch

    from oclcomputervision_tpu_torch.kernels import histeq as kh
    from oclcomputervision_tpu_torch.kernels import localeq as kl
    from oclcomputervision_tpu_torch.ops.histeq import calc_transfer_func

    errs = {k: 0.0 for k in GLOBAL_KERNELS + LOCAL_KERNELS}

    def check(name, tag, got, want):
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{name} {tag}: {tuple(got.shape)} {got.dtype} vs "
                                 f"{tuple(want.shape)} {want.dtype}")
        err = (got.double() - want.double()).abs().max().item()
        errs[name] = max(errs[name], err)
        print(f"{name} {tag} {tuple(got.shape)}: max|kernel - plain| = {err}")

    def run(tag, g_global, g_local, tile, blockshape, m4=None):
        flat = g_global.reshape(g_global.shape[0], -1)
        hist = kh.hist256(flat)
        check("hist256", tag, kh.hist256_kernel(flat), hist)
        luts = calc_transfer_func(hist, 1.0, 0.05, 2.0).to(torch.uint8)
        check("apply_lut", tag, kh.apply_lut_kernel(flat, luts), kh.apply_lut(flat, luts))
        tiles = kl.hist_tiles(g_local, tile)
        check("hist_tiles", tag, kl.hist_tiles_kernel(g_local, tile), tiles)
        if m4 is None:  # the op's own LUTs
            m4 = calc_transfer_func(tiles, 0.5, 0.05, 3.0)
        check("blend_blocks", tag, kl.blend_blocks_kernel(g_local, m4, blockshape),
              kl.blend_blocks(g_local, m4, blockshape))

    for name, x in batches.items():
        run(name, x, x[: LOCAL_SHAPE[0]], BLOCK, BLOCK)
    gen = torch.Generator(device=device).manual_seed(int(rng.integers(1 << 31)))
    odd = torch.randint(0, 256, (3, 101, 77), generator=gen, device=device, dtype=torch.uint8)
    # LUT values outside [0, 255] exercise the clip; (50, 38) blocks leave a
    # ragged edge the 2x2 grid must cover
    m_odd = torch.rand((3, 2, 2, 256), generator=gen, device=device) * 300.0 - 20.0
    run("odd", odd, odd, (101, 7), (50, 38), m_odd)
    # a row one byte past a 16-byte boundary: scalar head, vector body, tail
    row = batches["natural"].reshape(-1)[1 : 1 + 1_000_003].reshape(1, -1)
    check("hist256", "offset", kh.hist256_kernel(row), kh.hist256(row))
    lut = torch.randint(0, 256, (1, 256), generator=gen, device=device, dtype=torch.uint8)
    check("apply_lut", "offset", kh.apply_lut_kernel(row, lut), kh.apply_lut(row, lut))
    bad = {k: v for k, v in errs.items() if v != 0.0}
    if bad:
        raise AssertionError(f"histeq kernels differ from their plain versions: {bad}")
    return {k: {"max_abs_err": v} for k, v in errs.items()}


def histeq_main_path(batches, rng, device):
    """Phase 4b: the histeq ops end to end, each path with the launch counts
    set to 0 just before it and read just after; outputs against the plain
    path and one natural image against the numpy oracle."""
    import numpy as np
    import torch

    from oclcomputervision_tpu_torch import ops
    from oclcomputervision_tpu_torch.kernels import _build
    from oclcomputervision_tpu_torch.oracle import histeq as oracle
    from oclcomputervision_tpu_torch.ops.histeq import (
        PLAIN_STAGES,
        _histeq_global_batched,
        _histeq_local_batched,
    )

    def drive(tag, kernels, fn, *args):
        torch.cuda.synchronize()
        _build.reset_launches()
        out = fn(*args)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        print(f"{tag}: {tuple(args[0].shape)} uint8 -> {tuple(out.shape)} {out.dtype}, "
              f"launches {launches}")
        missing = [k for k in kernels if launches[k] < 1]
        if missing:
            raise AssertionError(f"{tag} launched no {missing} kernel")
        if out.shape != args[0].shape or out.dtype != torch.uint8:
            raise AssertionError(f"{tag} output {tuple(out.shape)} {out.dtype}")
        return out, launches

    def same(tag, got, want):
        if not torch.equal(got, want):
            n = (got != want).sum().item()
            raise AssertionError(f"{tag}: {n} pixels differ from the plain path")
        print(f"{tag}: equal to the plain path")

    x = batches["natural"]
    img0 = x[0].cpu().numpy()
    out, launches_g = drive("histeq_global", GLOBAL_KERNELS, ops.histeq_global, x)
    same("histeq_global", out, _histeq_global_batched(x, 1.0, 0.05, 2.0, PLAIN_STAGES))
    d = np.abs(out[0].cpu().numpy().astype(int) - oracle.histeq_global(img0).astype(int))
    print(f"histeq_global vs numpy oracle, natural {img0.shape}: max {d.max()}, "
          f"share off {(d > 0).mean():.7f} (<= 1 on < {HISTEQ_ORACLE_SHARE})")
    if d.max() > 1 or (d > 0).mean() >= HISTEQ_ORACLE_SHARE:
        raise AssertionError("histeq_global disagrees with the oracle")
    del out

    xl = x[: LOCAL_SHAPE[0]]
    launches_l = None
    for clahe in (0.0, 2.0):
        tag = f"histeq_local_block clahe_clip={clahe}"
        out, launches = drive(tag, LOCAL_KERNELS, ops.histeq_local_block,
                              xl, 0.5, 0.05, 3.0, BLOCK, clahe)
        launches_l = launches_l or launches
        same(tag, out, _histeq_local_batched(xl, 0.5, 0.05, 3.0, BLOCK, clahe, PLAIN_STAGES))
        want = oracle.histeq_local_block(img0.copy(), 0.5, 0.05, 3.0, BLOCK, clahe_clip=clahe)
        d = np.abs(out[0].cpu().numpy().astype(int) - want.astype(int))
        print(f"{tag} vs numpy oracle, natural {img0.shape}: max {d.max()} (<= 1)")
        if d.max() > 1:
            raise AssertionError(f"{tag} disagrees with the oracle")

    # caller-given mappings on a geometry the blocks do not divide
    m = ops.block_mappings(x[:2], 0.5, 0.05, 3.0, BLOCK)
    big = torch.from_numpy(lenna_batch(rng, *MAPPED_SHAPE)).to(device)
    out, _ = drive("apply_block_mappings", ("blend_blocks",), ops.apply_block_mappings,
                   big, m, BLOCK)
    same("apply_block_mappings", out, PLAIN_STAGES.blend(big, m, BLOCK))
    want = oracle.apply_block_mappings(big[0].cpu().numpy(), m[0].cpu().numpy(), BLOCK)
    d = np.abs(out[0].cpu().numpy().astype(int) - want.astype(int))
    print(f"apply_block_mappings {tuple(big.shape)}, {tuple(m.shape[1:3])} LUT grid vs "
          f"numpy oracle: max {d.max()} (<= 1)")
    if d.max() > 1:
        raise AssertionError("apply_block_mappings disagrees with the oracle")
    return {**{k: launches_g[k] for k in GLOBAL_KERNELS},
            **{k: launches_l[k] for k in LOCAL_KERNELS}}


def histeq_timing(batches, card, device):
    """Phase 6b: both ops' input MP/s through the kernels and the plain
    versions, their device profiles, and each kernel's, plain version's and
    single PyTorch call's time at the bench shapes."""
    import torch

    from oclcomputervision_tpu_torch import ops
    from oclcomputervision_tpu_torch.kernels import histeq as kh
    from oclcomputervision_tpu_torch.kernels import localeq as kl
    from oclcomputervision_tpu_torch.ops.histeq import (
        PLAIN_STAGES,
        _histeq_global_batched,
        _histeq_local_batched,
        calc_transfer_func,
    )
    from oclcomputervision_tpu_torch.utils import cuda_time_ms, device_profile

    x = batches["random"]  # bench.py's content
    xl = x[: LOCAL_SHAPE[0]]
    runs = {
        "histeq_global": (x, (ops.histeq_global, x),
                          (_histeq_global_batched, x, 1.0, 0.05, 2.0, PLAIN_STAGES)),
        "histeq_local_block": (xl, (ops.histeq_local_block, xl, 0.5, 0.05, 3.0, BLOCK),
                               (_histeq_local_batched, xl, 0.5, 0.05, 3.0, BLOCK, 0.0,
                                PLAIN_STAGES)),
    }
    e2e = {}
    for op, (inp, kern, plain) in runs.items():
        shape = "x".join(str(d) for d in inp.shape)
        mp = inp.numel() / 1e6
        ms_k, ms_p = cuda_time_ms(*kern), cuda_time_ms(*plain)
        print(f"[{card}] e2e {op} {shape} uint8 kernels: {ms_k:.4f} ms, "
              f"{mp / ms_k * 1e3:.2f} MP in/s")
        print(f"[{card}] e2e {op} {shape} uint8 plain:   {ms_p:.4f} ms, "
              f"{mp / ms_p * 1e3:.2f} MP in/s")
        per_kernel, idle = device_profile(*kern)
        print(f"[{card}] torch.profiler, device ms per call of {op} {shape} "
              f"(idle share {idle:.4f}):")
        for name, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1]):
            print(f"    {ms:9.4f}  {name[:90]}")
        e2e[op] = {"ms": ms_k, "plain_ms": ms_p, "idle_share": idle,
                   "mp_in_per_s": mp / ms_k * 1e3, "plain_mp_in_per_s": mp / ms_p * 1e3,
                   "device_ms": sum(per_kernel.values())}

    flat = x.reshape(x.shape[0], -1)
    hist = kh.hist256_kernel(flat)
    luts = calc_transfer_func(hist, 1.0, 0.05, 2.0).to(torch.uint8)
    tiles = kl.hist_tiles_kernel(xl, BLOCK)
    m4 = calc_transfer_func(tiles, 0.5, 0.05, 3.0)
    # the single PyTorch calls take int64 indices; building them is timed
    # apart (printed) and left out of library_ms
    rows = torch.arange(flat.shape[0], device=device)[:, None]
    bin_idx = (flat.long() + 256 * rows).reshape(-1)
    lut_idx = flat.long()
    nrow = flat.shape[0]
    # tile histograms: bin x + 256 * (flat tile index of the pixel)
    (nb, hl, wl), (th, tw) = xl.shape, BLOCK
    nty, ntx = hl // th, wl // tw
    ntile = nb * nty * ntx
    tile_off = 256 * ((torch.arange(nb, device=device)[:, None, None] * nty
                       + torch.arange(hl, device=device)[:, None] // th) * ntx
                      + torch.arange(wl, device=device) // tw)
    tile_idx = (xl.long() + tile_off).reshape(-1)
    library_out = {
        "hist256": (torch.bincount(bin_idx, minlength=256 * nrow).reshape(nrow, 256), hist),
        "apply_lut": (torch.gather(luts, 1, lut_idx), kh.apply_lut_kernel(flat, luts)),
        "hist_tiles": (torch.bincount(tile_idx, minlength=256 * ntile)
                       .reshape(nb, nty, ntx, 256), tiles),
    }
    for name, (lib, ours) in library_out.items():
        if not torch.equal(lib.to(ours.dtype), ours):
            raise AssertionError(f"the library call of {name} computes another function")
    print(f"library calls equal the kernels: {sorted(library_out)}")
    del library_out
    pairs = {
        "hist256": (lambda: kh.hist256_kernel(flat), lambda: kh.hist256(flat),
                    lambda: torch.bincount(bin_idx, minlength=256 * nrow),
                    lambda: torch.bincount((flat.long() + 256 * rows).reshape(-1),
                                           minlength=256 * nrow),
                    nbytes(flat, hist), flat.numel(), "torch.bincount(x + 256 b)"),
        "apply_lut": (lambda: kh.apply_lut_kernel(flat, luts), lambda: kh.apply_lut(flat, luts),
                      lambda: torch.gather(luts, 1, lut_idx),
                      lambda: torch.gather(luts, 1, flat.long()),
                      nbytes(flat, luts, flat), flat.numel(), "torch.gather(lut, 1, x)"),
        "hist_tiles": (lambda: kl.hist_tiles_kernel(xl, BLOCK), lambda: kl.hist_tiles(xl, BLOCK),
                       lambda: torch.bincount(tile_idx, minlength=256 * ntile),
                       lambda: torch.bincount((xl.long() + tile_off).reshape(-1),
                                              minlength=256 * ntile),
                       nbytes(xl, tiles), xl.numel(), "torch.bincount(x + 256 tile)"),
        "blend_blocks": (lambda: kl.blend_blocks_kernel(xl, m4, BLOCK),
                         lambda: kl.blend_blocks(xl, m4, BLOCK), None, None,
                         nbytes(xl, m4, xl), xl.numel(), "none"),
    }
    times = {}
    for name, (fk, fp, flib, flib_conv, moved, elems, lib_name) in pairs.items():
        shape = "x".join(str(d) for d in (x if name in GLOBAL_KERNELS else xl).shape)
        ms, call_ms, pms = kernel_ms(name, fk), cuda_time_ms(fk), cuda_time_ms(fp)
        lms = cuda_time_ms(flib) if flib else None
        bms, by = bound(name, moved, elems)
        times[name] = {"ms": ms, "call_ms": call_ms, "plain_ms": pms, "bound_ms": bms,
                       "bound_by": by, "library_ms": lms}
        lib = "none" if lms is None else (
            f"{lms:.4f} ms ({lib_name}; {cuda_time_ms(flib_conv):.4f} ms with the int64 "
            f"index build)")
        print(f"[{card}] {name} at {shape}: kernel {ms:.4f} ms (whole call {call_ms:.4f} ms), "
              f"plain {pms:.4f} ms, bound {bms:.4f} ms ({by}: {moved / 1e6:.1f} MB), "
              f"library {lib}")
    del bin_idx, lut_idx, tile_idx, tile_off
    # the histogram kernels' time on other content (atomics depend on it)
    for content in ("natural", "constant"):
        xc = batches[content]
        fc = xc.reshape(xc.shape[0], -1)
        xcl = xc[: LOCAL_SHAPE[0]]
        print(f"[{card}] hist256 at {GLOBAL_SHAPE} {content}: "
              f"{kernel_ms('hist256', lambda: kh.hist256_kernel(fc)):.4f} ms; hist_tiles at "
              f"{LOCAL_SHAPE} {content}: "
              f"{kernel_ms('hist_tiles', lambda: kl.hist_tiles_kernel(xcl, BLOCK)):.4f} ms")
    return times, e2e


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

    # phase 3b: the histeq kernels against their plain versions
    batches = histeq_batches(rng, device)
    errs.update(histeq_kernel_vs_plain(batches, rng, device))

    # phase 4: RAISR end to end
    batch = lenna_batch(rng, BATCH, LR)
    out, launches = main_path(model, batch, load_image("lenna.png"), device)

    # phase 4b: histeq end to end
    launches.update(histeq_main_path(batches, rng, device))

    # phase 5: quality
    quality(model)

    # phase 6: RAISR timing
    times, e2e = timing(model, batch, out, card, device)
    del out

    # phase 6b: histeq timing
    histeq_times, histeq_e2e = histeq_timing(batches, card, device)
    times.update(histeq_times)
    e2e = {"raisr_x2": e2e, **histeq_e2e}

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
    if "jax" in sys.modules or "oclcomputervision_tpu" in sys.modules:
        raise AssertionError("jax or the JAX package was imported")
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
