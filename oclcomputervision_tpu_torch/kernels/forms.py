"""Time alternative CUDA sources of one kernel against each other on the card.

    python3 -m oclcomputervision_tpu_torch.kernels.forms KERNEL LABEL=SOURCE[|OLD|NEW]... ...

Each form is a ``.cu`` source with the kernel's C entry point (the one
``_build._SIGNATURES`` names), optionally with each literal text OLD replaced
by its NEW first (each must occur). Every form is built alone with the library's
nvcc flags into ``build/kernel_forms/`` and timed with torch.profiler (the
kernel's own device time, 5 calls after a warm-up) on the inputs
``chip_smoke.py`` times that kernel at, in turns (forms in order, then in
reverse order, three times), and checked equal to the plain version. KERNEL
is ``blend_blocks`` (64 x 768 x 1280 at 256^2 blocks, ms per launch) or
``me_fast_round`` (4 noisy VGA pairs, search 15 and patch 5: three rounds,
ms per 3 launches). Prints one line per form and turn, and a JSON line of
the medians. Needs the card: a CPU run is refused.
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
ENTRY = {"blend_blocks": "ocvk_blend_blocks", "me_fast_round": "ocvk_me_fast_round"}


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
    from oclcomputervision_tpu_torch.utils import device_profile

    per_kernel, _ = device_profile(fn)
    hits = [ms for k, ms in per_kernel.items() if f"{name}_kernel" in k]
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

    def run(fn):
        rc = fn(x.data_ptr(), m4.data_ptr(), out.data_ptr(), b, h, w, nby, nbx, *block, rpb,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"launch failed: {rc}")
        return out

    return run, kl.blend_blocks(x, m4, block)


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

    def run(fn):
        dy = dx = None
        for r, step in enumerate(steps):
            rc = fn(f0.data_ptr(), f1.data_ptr(), dy, dx, states[r, 0].data_ptr(),
                    states[r, 1].data_ptr(), b, h, w, 5, step, 0,
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"launch failed: {rc}")
            dy, dx = states[r, 0].data_ptr(), states[r, 1].data_ptr()
        return states

    # the plain rounds without the median
    dy = dx = torch.zeros((b, h, w), dtype=torch.int32, device=device)
    want = []
    for step in steps:
        dy, dx = km.fast_round(f0, f1, dy, dx, step, 5, "sad")
        want.append(torch.stack([dy, dx]).to(torch.int32))
    return run, torch.stack(want)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernel", choices=sorted(ENTRY))
    ap.add_argument("forms", nargs="+", help="LABEL=SOURCE or LABEL=SOURCE|OLD|NEW[|OLD|NEW...]")
    args = ap.parse_args()
    device = require_cuda()
    case = blend_case if args.kernel == "blend_blocks" else round_case
    run, want = case(device)
    fns = {}
    for form in args.forms:
        label, spec = form.split("=", 1)
        fn = getattr(build_form(label, spec), ENTRY[args.kernel])
        fn.argtypes = _build._SIGNATURES[ENTRY[args.kernel]]
        fn.restype = ctypes.c_int
        got = run(fn)
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        print(f"{label}: {'equal to' if same else 'DIFFERENT from'} the plain version")
        fns[label] = fn
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    times = {label: [] for label in fns}
    order = list(fns)
    for turn in range(6):
        for label in (order if turn % 2 == 0 else order[::-1]):
            ms = kernel_ms(lambda fn=fns[label]: run(fn), args.kernel)
            times[label].append(ms)
            print(f"[{card}] {args.kernel} {label} turn {turn}: {ms:.4f} ms")
    print(json.dumps({"kernel": args.kernel, "card": card,
                      "median_ms": {k: statistics.median(v) for k, v in times.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
