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
  and x5 on 16 x 1024^2, the buckets the hash's;
- ``raisr_apply_split``: x2 filter_len 17 with 5 strength quantizers (432
  buckets) on 4 x 256^2 and 16 x 1024^2, and x3 filter_len 25 with the
  same buckets on 4 x 256^2, the buckets the hash's. A form may export
  ``ocvk_raisr_apply_split`` (timed at the plan ``split_plan`` picks, or at
  each count of splits ``--splits`` lists) or ``ocvk_raisr_apply_generic_l2``
  (the one-thread-per-pixel form the split form replaced: its source is in
  the git history, before ``raisr_apply_split.cu`` was added);
- ``me_fast_median``: the fast search's three rounds on 4 noisy VGA pairs
  (search 15, patch 5), each round's output filtered by the form, ms per 3
  launches: as on the path, each launch right after its round (inputs in
  L2), and with L2 flushed before each launch.

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
    "me_fast_median": ("ocvk_me_fast_median",),
    "raisr_hash_generic": ("ocvk_raisr_hash_generic",),
    "raisr_apply_generic": ("ocvk_raisr_apply_generic",),
    "raisr_apply_split": ("ocvk_raisr_apply_split", "ocvk_raisr_apply_generic_l2"),
}
# entry points of earlier forms that the library no longer has: planes,
# buckets, bank (fl*fl taps padded to a multiple of 8), out, nimg, nb, s,
# fl, hp, rows, wq, h2p, w2p, nbucket, row_stride, stream
_EARLIER = {"ocvk_raisr_apply_generic_l2": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11
            + [ctypes.c_void_p]}


def entry(lib: ctypes.CDLL, kernel: str):
    """(name, function) of the entry point of ``kernel`` that ``lib`` exports."""
    for name in ENTRIES[kernel]:
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = _build._SIGNATURES.get(name) or _EARLIER[name]
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
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.SRC_DIR, "-shared", "-o", so,
                    cu, errs], check=True)
    return ctypes.CDLL(so)


def kernel_ms(fn, kernel: str) -> float:
    """Device ms per call of the kernels named after one of ``kernel``'s
    entry points (``raisr_apply_split`` also finds
    ``raisr_apply_generic_l2_kernel``)."""
    from oclcomputervision_tpu_torch.utils import device_profile

    names = [e[len("ocvk_"):] for e in ENTRIES[kernel]]
    per_kernel, _ = device_profile(fn)
    hits = [ms for k, ms in per_kernel.items() if any(n in k for n in names)]
    if not hits:
        raise AssertionError(f"the profiler saw no {names} kernel in {sorted(per_kernel)}")
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
        _check(fn(x.data_ptr(), m4.data_ptr(), out.data_ptr(), b, h, w, 0, nby, nbx, *block, rpb,
                  torch.cuda.current_stream().cuda_stream))
        return out

    return [("64x768x1280", run, kl.blend_blocks(x, m4, block), "the plain version")]


def round_case(device):
    """Three rounds (steps 5, 2, 1) of the fast search on 4 noisy VGA pairs,
    each round's state the last one's output: the plain rounds' states."""
    from oclcomputervision_tpu_torch.kernels import motion as km

    f0, f1 = _noisy_pairs(device)
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


def median_cases(device):
    """The three rounds (steps 5, 2, 1) of the fast search on 4 noisy VGA
    pairs, each round (the library's kernel) followed by a median launch of
    the form, the last one writing the flow: the plain iteration's flow.
    Twice: as the path runs it, and with a 256 MB buffer written before each
    median launch, so that it finds its inputs in device memory."""
    from oclcomputervision_tpu_torch.kernels import motion as km

    f0, f1 = _noisy_pairs(device)
    b, h, w = f0.shape
    steps = km.me_steps(15, 5)
    moved = torch.empty((2, b, h, w), dtype=torch.int32, device=device)
    state = torch.empty_like(moved)
    flow = torch.empty((b, h, w, 2), dtype=torch.float32, device=device)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=device)

    def run(lib, cold):
        _, fn = entry(lib, "me_fast_median")
        dy = dx = None
        for r, step in enumerate(steps):
            km._launch_round(f0, f1, dy, dx, moved, 5, step, "sad")
            if cold:
                flush.fill_(1.0)
            last = r == len(steps) - 1
            _check(fn(moved[0].data_ptr(), moved[1].data_ptr(),
                      None if last else state[0].data_ptr(), None if last else state[1].data_ptr(),
                      flow.data_ptr() if last else None, b, h, w,
                      torch.cuda.current_stream().cuda_stream))
            dy, dx = state[0], state[1]
        return flow

    want = km.me_fast(f0, f1, 15, 5, "sad")
    return [(f"4x480x640{tag}", lambda lib, cold=cold: run(lib, cold), want, "the plain version")
            for tag, cold in (("", False), (" L2 flushed", True))]


def _noisy_pairs(device):
    """4 noisy VGA pairs: the Middlebury frames plus noise in [-4, 4], seed 0."""
    from oclcomputervision_tpu_torch.utils import load_gray

    rng = np.random.default_rng(0)
    return (
        torch.from_numpy(np.clip(load_gray(name).astype(np.int16)[None]
                                 + rng.integers(-4, 5, (4, 480, 640)), 0, 255)
                         .astype(np.uint8)).to(device)
        for name in ("frame10.png", "frame11.png"))


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
    "raisr_apply_split": (
        ({"filter_len": 17, "num_strength": 6, "strength_quantizers": QUANT5}, (4, 256)),
        ({"filter_len": 17, "num_strength": 6, "strength_quantizers": QUANT5}, (16, 1024)),
        ({"scale": 3, "filter_len": 25, "num_strength": 6, "strength_quantizers": QUANT5},
         (4, 256)),
    ),
}


def _apply_launches(kernel, up, hb, out, filters, cfg, geo, splits):
    """Entry point (with the split count, for the split form) -> a function
    of it that launches it on these planes and buckets, the bank and tables
    laid out first; split counts with no plan that fits are left out."""
    from oclcomputervision_tpu_torch.kernels import raisr as kr

    s, fl = cfg.scale, cfg.filter_len
    nbk = cfg.num_angle * cfg.num_strength * cfg.num_coherence
    n = up.shape[0]
    common = (n, n, s, fl, geo.hp, up.shape[2], up.shape[3], geo.h2p, geo.w2p, nbk)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    launches = {}
    if kernel == "raisr_apply_generic":
        res = kr._bank_rows(filters, cfg, 2 * kr.generic_row_words(fl))[0]
        taps = kr._tap_table_on(s, fl, up.device)
        launches["ocvk_raisr_apply_generic"] = lambda fn: fn(
            up.data_ptr(), hb.data_ptr(), res.data_ptr(), taps.data_ptr(), out.data_ptr(),
            *common, kr.generic_row_words(fl), kr.generic_apply_phases(s, fl, nbk), stream())
        return launches
    l2 = kr._bank_rows(filters, cfg, -(-fl * fl // 8) * 8)[0]
    launches["ocvk_raisr_apply_generic_l2"] = lambda fn: fn(
        up.data_ptr(), hb.data_ptr(), l2.data_ptr(), out.data_ptr(), *common, l2.shape[-1],
        stream())
    for count in splits or (None,):
        try:
            plan = kr.split_plan(s, fl, nbk, count)
        except ValueError as exc:
            print(f"x{s} fl{fl}: {exc}")
            continue
        bank = kr._bank_rows(filters, cfg, 2 * kr.odd_words(plan.q), plan.q)[0]
        table = torch.from_numpy(plan.table).to(up.device)
        launches[("ocvk_raisr_apply_split", count)] = (
            lambda fn, bank=bank, table=table, plan=plan: fn(
                up.data_ptr(), hb.data_ptr(), bank.data_ptr(), table.data_ptr(), out.data_ptr(),
                *common, kr.odd_words(plan.q), plan.nsplit, plan.q, plan.maxp, stream()))
    return launches


def raisr_cases(device, kernel: str, splits=None):
    """The generic hash's or an apply form's inputs at each RAISR_INPUTS
    entry (lenna as chip_smoke.lenna_batch builds it, a bank from seed 0),
    each with what a form must equal: the plain version on 4 x 256^2, the
    library's own form at the bench geometry. ``splits``: the split apply
    at ``split_plan``'s plan for each of these split counts (None: the
    plan it picks)."""
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
            out = torch.empty(shape, dtype=torch.float32, device=device)
            launches = _apply_launches(kernel, up, hb, out, filters, cfg, geo, splits)

            def run(lib, count=None, kernel=kernel, launches=launches, out=out):
                name, fn = entry(lib, kernel)
                key = (name, count) if name == "ocvk_raisr_apply_split" else name
                if key not in launches:
                    return None  # no plan of that many splits fits this config
                _check(launches[key](fn))
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
    ap.add_argument("--splits", type=lambda v: [int(x) for x in v.split(",")],
                    help="raisr_apply_split: time each split form at these split counts, e.g. 2,3")
    args = ap.parse_args()
    device = require_cuda()
    if args.kernel == "blend_blocks":
        cases = blend_case(device)
    elif args.kernel == "me_fast_round":
        cases = round_case(device)
    elif args.kernel == "me_fast_median":
        cases = median_cases(device)
    else:
        cases = raisr_cases(device, args.kernel, args.splits)
    libs = {}  # label -> a function of the case's run that runs this form
    for form in args.forms:
        label, spec = form.split("=", 1)
        lib = build_form(label, spec)
        if entry(lib, args.kernel)[0] == "ocvk_raisr_apply_split" and args.splits:
            for count in args.splits:
                libs[f"{label} {count} splits"] = lambda run, lib=lib, count=count: run(lib, count)
        else:
            libs[label] = lambda run, lib=lib: run(lib)
    skip = set()  # (label, tag) of a split count no plan of which fits the case
    for label, form_run in libs.items():
        for tag, run, want, ref in cases:
            got = form_run(run)
            if got is None:
                skip.add((label, tag))
                continue
            torch.cuda.synchronize()
            same = torch.equal(got, want)
            print(f"{label} {tag}: {'equal to' if same else 'DIFFERENT from'} {ref}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    medians = {}
    for tag, run, _, _ in cases:
        order = [label for label in libs if (label, tag) not in skip]
        times = {label: [] for label in order}
        for turn in range(6):
            for label in (order if turn % 2 == 0 else order[::-1]):
                ms = kernel_ms(lambda form_run=libs[label]: form_run(run), args.kernel)
                times[label].append(ms)
                print(f"[{card}] {args.kernel} {tag} {label} turn {turn}: {ms:.4f} ms")
        medians[tag] = {k: statistics.median(v) for k, v in times.items()}
    print(json.dumps({"kernel": args.kernel, "card": card, "median_ms": medians}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
