"""Time alternative CUDA sources of one kernel against each other on the card.

    python3 -m oclcomputervision_tpu_torch.kernels.forms KERNEL LABEL=SOURCE[|OLD|NEW]... ...

Each form is a ``.cu`` source with one of the kernel's C entry points (those
``ENTRIES`` names, with the argument types ``_build._SIGNATURES`` gives),
optionally with each literal text OLD replaced by its NEW first (each must
occur). Every form is built alone with the library's nvcc flags into
``build/kernel_forms/`` and timed with torch.profiler (the kernel's own
device time, 5 calls after a warm-up) on the inputs ``chip_smoke.py`` times
that kernel at, in turns (forms in order, then in reverse order, three
times), and checked equal to the plain version (at the bench geometry of
the RAISR kernels, where the plain version is too slow, to the library's
own form, which ``chip_smoke.py`` holds to it). KERNEL is

- ``blend_blocks``: 64 x 768 x 1280 at 256^2 blocks, ms per launch;
- ``me_fast_round``: 4 noisy VGA pairs, search 15 and patch 5: three
  rounds, ms per 3 launches;
- ``raisr_hash_generic``: x2 with gauss_len 7 and 5 strength quantizers on
  4 x 256^2 lenna (phase 6d) and on 16 x 1024^2 (6e), and x5 on 16 x 1024^2;
- ``raisr_apply_generic``: x2 filter_len 13 on 4 x 256^2 and 16 x 1024^2,
  and x5 on 16 x 1024^2, the buckets the hash's. A form may export
  ``ocvk_raisr_apply_generic`` (the resident-bank form) or
  ``ocvk_raisr_apply_generic_l2`` (the one-thread-per-pixel L2 form).

Prints one line per form, input and turn, and a JSON line of the medians.
Needs the card: a CPU run is refused.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

from oclcomputervision_tpu_torch._device import require_cuda
from oclcomputervision_tpu_torch.kernels import _build

FORMS_DIR = os.path.join(os.path.dirname(_build.BUILD_DIR), "kernel_forms")
# kernel -> the C entry points a form of it may export
ENTRIES = {
    "blend_blocks": ("ocvk_blend_blocks",),
    "me_fast_round": ("ocvk_me_fast_round",),
    "raisr_hash_generic": ("ocvk_raisr_hash_generic",),
    "raisr_apply_generic": ("ocvk_raisr_apply_generic", "ocvk_raisr_apply_generic_l2"),
}


def entry(lib: ctypes.CDLL, kernel: str):
    """(name, function) of the entry point of ``kernel`` that ``lib`` exports."""
    for name in ENTRIES[kernel]:
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = _build._SIGNATURES[name]
            fn.restype = ctypes.c_int
            return name, fn
    raise ValueError(f"the form exports none of {ENTRIES[kernel]}")


def _check(rc: int) -> None:
    if rc:
        raise RuntimeError(f"launch failed: {rc}")


def build_form(label: str, spec: str) -> ctypes.CDLL:
    """Build form ``spec`` (``path`` or ``path|OLD|NEW``) into its own library."""
    path, *sub = spec.split("|")
    with open(path) as f:
        src = f.read()
    for old, new in zip(sub[::2], sub[1::2]):
        if old not in src:
            raise ValueError(f"{label}: {old!r} does not occur in {path}")
        src = src.replace(old, new)
    os.makedirs(FORMS_DIR, exist_ok=True)
    cu = os.path.join(FORMS_DIR, f"{label}.cu")
    so = os.path.join(FORMS_DIR, f"{label}.so")
    with open(cu, "w") as f:
        f.write(src)
    errs = os.path.join(_build.SRC_DIR, "errors.cu")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", so, cu, errs],
                   check=True)
    return ctypes.CDLL(so)


def kernel_ms(fn, name: str) -> float:
    """Device ms per call of the kernels whose names contain ``name`` (every
    form of a kernel is named after it: ``raisr_apply_generic`` also finds
    ``raisr_apply_generic_l2_kernel``)."""
    from oclcomputervision_tpu_torch.utils import device_profile

    per_kernel, _ = device_profile(fn)
    hits = [ms for k, ms in per_kernel.items() if name in k]
    if not hits:
        raise AssertionError(f"the profiler saw no {name} kernel in {sorted(per_kernel)}")
    return sum(hits)


def blend_case(device):
    """The bench's local histeq blend: inputs, one launch, the plain output."""
    from oclcomputervision_tpu_torch.kernels import localeq as kl
    from oclcomputervision_tpu_torch.ops.histeq import calc_transfer_func

    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randint(0, 256, (64, 768, 1280), generator=gen, device=device, dtype=torch.uint8)
    block = (256, 256)
    m4 = calc_transfer_func(kl.hist_tiles_kernel(x, block), 0.5, 0.05, 3.0).contiguous()
    b, h, w = x.shape
    nby, nbx = m4.shape[1:3]
    rpb = kl._rows_per_block(*block, kl.BLEND_BLOCK_PIXELS)
    out = torch.empty_like(x)

    def run(lib):
        _, fn = entry(lib, "blend_blocks")
        _check(fn(x.data_ptr(), m4.data_ptr(), out.data_ptr(), b, h, w, nby, nbx, *block, rpb,
                  torch.cuda.current_stream().cuda_stream))
        return out

    return [("64x768x1280", run, kl.blend_blocks(x, m4, block), "the plain version")]


def round_case(device):
    """Three rounds (steps 5, 2, 1) of the fast search on 4 noisy VGA pairs,
    each round's state the last one's output: the plain rounds' states."""
    from oclcomputervision_tpu_torch.kernels import motion as km
    from oclcomputervision_tpu_torch.utils import load_gray

    rng = np.random.default_rng(0)
    f0, f1 = (
        torch.from_numpy(np.clip(load_gray(name).astype(np.int16)[None]
                                 + rng.integers(-4, 5, (4, 480, 640)), 0, 255)
                         .astype(np.uint8)).to(device)
        for name in ("frame10.png", "frame11.png"))
    b, h, w = f0.shape
    steps = km.me_steps(15, 5)
    states = torch.empty((len(steps), 2, b, h, w), dtype=torch.int32, device=device)

    def run(lib):
        _, fn = entry(lib, "me_fast_round")
        dy = dx = None
        for r, step in enumerate(steps):
            _check(fn(f0.data_ptr(), f1.data_ptr(), dy, dx, states[r, 0].data_ptr(),
                      states[r, 1].data_ptr(), b, h, w, 5, step, 0,
                      torch.cuda.current_stream().cuda_stream))
            dy, dx = states[r, 0].data_ptr(), states[r, 1].data_ptr()
        return states

    # the plain rounds without the median
    dy = dx = torch.zeros((b, h, w), dtype=torch.int32, device=device)
    want = []
    for step in steps:
        dy, dx = km.fast_round(f0, f1, dy, dx, step, 5, "sad")
        want.append(torch.stack([dy, dx]).to(torch.int32))
    return [("4x480x640", run, torch.stack(want), "the plain version")]


QUANT5 = (1e-5, 1e-4, 1e-3, 1e-2, 1e-1)
# (config change, LR batch) of each RAISR input: phase 6d's, then 6e's
RAISR_INPUTS = {
    "raisr_hash_generic": (
        ({"filter_len": 7, "gauss_len": 7, "num_strength": 6, "strength_quantizers": QUANT5},
         (4, 256)),
        ({"filter_len": 7, "gauss_len": 7, "num_strength": 6, "strength_quantizers": QUANT5},
         (16, 1024)),
        ({"scale": 5}, (16, 1024)),
    ),
    "raisr_apply_generic": (
        ({"filter_len": 13}, (4, 256)),
        ({"filter_len": 13}, (16, 1024)),
        ({"scale": 5}, (16, 1024)),
    ),
}


def raisr_cases(device, kernel: str):
    """The generic hash's or apply's inputs at each RAISR_INPUTS entry (lenna
    as chip_smoke.lenna_batch builds it, a bank from seed 0), each with what
    a form must equal: the plain version on 4 x 256^2, the library's own
    form at the bench geometry."""
    import dataclasses

    from oclcomputervision_tpu_torch.kernels import raisr as kr
    from oclcomputervision_tpu_torch.kernels import upscale as ku
    from oclcomputervision_tpu_torch.ops.raisr import plane_geometry
    from oclcomputervision_tpu_torch.utils import load_gray
    from oclcomputervision_tpu_torch.utils.config import RaisrConfig

    rng = np.random.default_rng(0)
    base = load_gray("lenna.png")
    cases = []
    for change, (n, lr) in RAISR_INPUTS[kernel]:
        cfg = dataclasses.replace(RaisrConfig(), **change)
        s, fl = cfg.scale, cfg.filter_len
        tile = np.tile(base, (-(-lr // base.shape[0]), -(-lr // base.shape[1])))[:lr, :lr]
        x = np.stack([np.clip(np.roll(tile.astype(np.int16) + rng.integers(-8, 9, tile.shape),
                                      rng.integers(0, 512, 2), (0, 1)), 0, 255)
                      for _ in range(n)]).astype(np.uint8)
        x01 = torch.from_numpy(x).to(device).float() / torch.tensor(255.0, device=device)
        geo = plane_geometry(lr, lr, cfg)
        up = ku.upscale_planes_kernel(x01, cfg, geo.hq, geo.wq, geo.hp)
        del x01
        nbk = cfg.num_angle * cfg.num_strength * cfg.num_coherence
        ss = s * s
        shape = (n, ss, geo.h2p, geo.w2p)
        tag = f"x{s} fl{fl} gl{cfg.gauss_len} {n}x{lr}^2"
        stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
        if kernel == "raisr_hash_generic":
            prm = torch.from_numpy(kr.hash_params_generic(cfg)).to(device)
            out = torch.empty(shape, dtype=torch.int32, device=device)

            def run(lib, cfg=cfg, up=up, geo=geo, prm=prm, out=out):
                _, fn = entry(lib, "raisr_hash_generic")
                _check(fn(up.data_ptr(), out.data_ptr(), prm.data_ptr(), up.shape[0], cfg.scale,
                          cfg.gauss_len, len(cfg.strength_quantizers),
                          len(cfg.coherence_quantizers), cfg.num_angle, cfg.num_strength,
                          cfg.num_coherence, geo.hp, up.shape[2], up.shape[3], geo.h2p,
                          geo.w2p, stream()))
                return out

            small = n * lr * lr <= 4 * 256 * 256
            want = (kr.hash_planes if small else kr.hash_planes_kernel)(
                up, cfg, geo.hp, geo.h2p, geo.w2p)
        else:
            bank_np = rng.normal(0.0, 0.02, (cfg.num_filters, fl, fl)).astype(np.float32)
            bank_np[:, fl // 2, fl // 2] += 1.0
            filters = torch.from_numpy(bank_np).to(device)
            hb = kr.hash_planes_kernel(up, cfg, geo.hp, geo.h2p, geo.w2p)
            res = kr._bank_rows(filters, cfg, 2 * kr.generic_row_words(fl))[0]
            l2 = kr._bank_rows(filters, cfg, -(-fl * fl // 8) * 8)[0]
            taps = kr._tap_table_on(s, fl, up.device)
            out = torch.empty(shape, dtype=torch.float32, device=device)

            def run(lib, cfg=cfg, up=up, hb=hb, res=res, l2=l2, taps=taps, out=out, nbk=nbk,
                    geo=geo):
                name, fn = entry(lib, "raisr_apply_generic")
                s, fl = cfg.scale, cfg.filter_len
                common = (up.shape[0], hb.shape[0], s, fl, geo.hp, up.shape[2], up.shape[3],
                          geo.h2p, geo.w2p, nbk)
                if name == "ocvk_raisr_apply_generic":
                    _check(fn(up.data_ptr(), hb.data_ptr(), res.data_ptr(), taps.data_ptr(),
                              out.data_ptr(), *common, kr.generic_row_words(fl),
                              kr.generic_apply_phases(s, fl, nbk), stream()))
                else:
                    _check(fn(up.data_ptr(), hb.data_ptr(), l2.data_ptr(), out.data_ptr(),
                              *common, l2.shape[-1], stream()))
                return out

            small = n * lr * lr <= 4 * 256 * 256
            want = (kr.apply_filters_planes if small else kr.apply_filters_planes_kernel)(
                up, hb, filters, cfg)
        cases.append((tag, run, want, "the plain version" if small else "the library's form"))
    return cases


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernel", choices=sorted(ENTRIES))
    ap.add_argument("forms", nargs="+", help="LABEL=SOURCE or LABEL=SOURCE|OLD|NEW[|OLD|NEW...]")
    args = ap.parse_args()
    device = require_cuda()
    if args.kernel == "blend_blocks":
        cases = blend_case(device)
    elif args.kernel == "me_fast_round":
        cases = round_case(device)
    else:
        cases = raisr_cases(device, args.kernel)
    libs = {}
    for form in args.forms:
        label, spec = form.split("=", 1)
        libs[label] = build_form(label, spec)
        for tag, run, want, ref in cases:
            got = run(libs[label])
            torch.cuda.synchronize()
            same = torch.equal(got, want)
            print(f"{label} {tag}: {'equal to' if same else 'DIFFERENT from'} {ref}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    medians = {}
    for tag, run, _, _ in cases:
        times = {label: [] for label in libs}
        order = list(libs)
        for turn in range(6):
            for label in (order if turn % 2 == 0 else order[::-1]):
                ms = kernel_ms(lambda lib=libs[label]: run(lib), args.kernel)
                times[label].append(ms)
                print(f"[{card}] {args.kernel} {tag} {label} turn {turn}: {ms:.4f} ms")
        medians[tag] = {k: statistics.median(v) for k, v in times.items()}
    print(json.dumps({"kernel": args.kernel, "card": card, "median_ms": medians}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
