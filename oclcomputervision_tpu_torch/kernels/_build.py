"""Build the CUDA kernels in ``csrc/`` with nvcc and bind them with ctypes.

All ``csrc/*.cu`` files compile, one nvcc process per source and all started
together, into objects that one more nvcc call links into one shared library
with a plain C interface (``build/ocv_torch_kernels/libocvk.so`` under the
repository root). No PyTorch header is included, so a build takes seconds.
The library is rebuilt whenever a source or a flag changes (a SHA-256 stamp
sits beside it) and is built at first use, never at import.

Every C entry point takes device pointers, sizes and the CUDA stream, launches
on that stream and returns ``cudaGetLastError()``; ``launch`` raises on a
non-zero code. The same pattern as ``oclcomputervision_tpu/utils/_native.py``
with ``native/build.py``, for the GPU.

``LAUNCHES`` counts kernel launches per kernel: each wrapper adds one where
it launches its kernel and nowhere else, so a run can show that it went
through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(_PKG_DIR)), "build", "ocv_torch_kernels"
)
LIB_PATH = os.path.join(BUILD_DIR, "libocvk.so")

# sm_90a: Hopper (H100/H200). -fmad=false keeps every multiply and add
# separately rounded, as the plain PyTorch versions and the JAX reference
# compute them; kernels that want a fused multiply-add call fmaf() itself.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-fmad=false",
)

LAUNCHES = {
    "upscale_planes": 0,
    "raisr_hash": 0,
    "raisr_apply": 0,
    # the RAISR kernels' generic forms, for configs outside the compiled ones
    "upscale_planes_generic": 0,
    "raisr_hash_generic": 0,
    "raisr_apply_generic": 0,
    # the apply's form for a bank of which one phase does not fit a block
    "raisr_apply_split": 0,
    "hist256": 0,
    "apply_lut": 0,
    "hist_tiles": 0,
    "blend_blocks": 0,
    "me_exact": 0,
    "me_fast_round": 0,
    "me_fast_median": 0,
    "resize_sep": 0,
}

_VP = ctypes.c_void_p
_I = ctypes.c_int
# entry point -> argtypes (every pointer and the stream as c_void_p)
_SIGNATURES = {
    # x, out, row_idx, row_w, col_idx, col_w,
    # nimg, h, w, s, hq, wq, tile_h, tile_w, span_h, span_w, stream
    "ocvk_upscale_planes": [_VP] * 6 + [_I] * 10 + [_VP],
    # planes, out, params (host struct), nimg, s, hp, rows, wq, h2p, w2p, stream
    "ocvk_raisr_hash": [_VP] * 3 + [_I] * 7 + [_VP],
    # planes, out, params (device array), nimg, s, gl, nsq, ncq, na, ns, nc,
    # hp, rows, wq, h2p, w2p, stream
    "ocvk_raisr_hash_generic": [_VP] * 3 + [_I] * 13 + [_VP],
    # planes, buckets, bank, out, nimg, nb, s, fl, hp, rows, wq, h2p,
    # w2p, nbucket, row_stride, stream
    "ocvk_raisr_apply": [_VP] * 4 + [_I] * 11 + [_VP],
    # planes, buckets, bank, plan, out, nimg, nb, s, fl, hp, rows, wq, h2p,
    # w2p, nbucket, row_words, nsplit, q, maxp, stream
    "ocvk_raisr_apply_split": [_VP] * 5 + [_I] * 14 + [_VP],
    # planes, buckets, bank, taps, out, nimg, nb, s, fl, hp, rows, wq, h2p,
    # w2p, nbucket, row_words, phases, stream
    "ocvk_raisr_apply_generic": [_VP] * 5 + [_I] * 12 + [_VP],
    # x, out, nimg, n, stream
    "ocvk_hist256": [_VP] * 2 + [_I] * 2 + [_VP],
    # x, luts, out, nimg, n, stream
    "ocvk_apply_lut": [_VP] * 3 + [_I] * 2 + [_VP],
    # x, out, nimg, h, w, th, tw, rows_per_block, stream
    "ocvk_hist_tiles": [_VP] * 2 + [_I] * 6 + [_VP],
    # x, m, out, nimg, h, w, row0, nby, nbx, bh, bw, rows_per_block, stream
    "ocvk_blend_blocks": [_VP] * 3 + [_I] * 9 + [_VP],
    # f0, f1, seed, out, steps (host ints), nsteps, nimg, h, w, ps, ssd,
    # bound, shipped, win_cap, stream
    "ocvk_me_exact": [_VP] * 5 + [_I] * 9 + [_VP],
    # f0, f1, dy_in, dx_in, dy_out, dx_out, nimg, h, w, ps, step, ssd, stream
    "ocvk_me_fast_round": [_VP] * 6 + [_I] * 6 + [_VP],
    # dy_in, dx_in, dy_out, dx_out, flow, nimg, h, w, stream
    "ocvk_me_fast_median": [_VP] * 5 + [_I] * 3 + [_VP],
    # x, out, row_idx, row_w, col_idx, col_w, nimg, h_in, w_in, h_out, w_out,
    # nch, taps, in_u8, out_u8, tile_h, tile_w, span_h, pitch, vec_in, clamp,
    # clamp_hi, stream
    "ocvk_resize_sep": [_VP] * 6 + [_I] * 15 + [ctypes.c_float] + [_VP],
}

_lib: ctypes.CDLL | None = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _sources() -> list[str]:
    return sorted(
        os.path.join(SRC_DIR, f)
        for f in os.listdir(SRC_DIR)
        if f.endswith((".cu", ".cuh"))
    )


def _digest(sources: list[str]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def build() -> float:
    """Build the library if it is missing or stale; returns the seconds
    spent compiling (0.0 when the stamp matched)."""
    sources = _sources()
    digest = _digest(sources)
    stamp = LIB_PATH + ".sha256"
    if os.path.isfile(LIB_PATH) and os.path.isfile(stamp):
        with open(stamp) as f:
            if f.read().strip() == digest:
                return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    units = [s for s in sources if s.endswith(".cu")]
    objects = [
        os.path.join(BUILD_DIR, f"{os.path.basename(s)[:-3]}.{tag}.o") for s in units
    ]
    tmp = f"{LIB_PATH}.{tag}"
    t0 = time.perf_counter()
    try:
        procs = [
            (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for cmd in ([_nvcc(), *NVCC_FLAGS, "-c", "-o", o, s] for s, o in zip(units, objects))
        ]
        results = [(cmd, proc.communicate()[0], proc.returncode) for cmd, proc in procs]
        link = [_nvcc(), *NVCC_FLAGS, "-shared", "-o", tmp, *objects]
        if all(rc == 0 for _, _, rc in results):
            res = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            results.append((link, res.stdout, res.returncode))
    finally:
        for o in objects:
            if os.path.exists(o):
                os.remove(o)
    secs = time.perf_counter() - t0
    failed = [(cmd, out, rc) for cmd, out, rc in results if rc != 0]
    if failed:
        raise RuntimeError("\n".join(
            f"nvcc failed (exit {rc}):\n{' '.join(cmd)}\n{out}" for cmd, out, rc in failed
        ))
    os.replace(tmp, LIB_PATH)
    with open(stamp, "w") as f:
        f.write(digest)
    return secs


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(LIB_PATH)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.ocvk_error_string.argtypes = [ctypes.c_int]
        lib.ocvk_error_string.restype = ctypes.c_char_p
        # s, fl, nbucket, phases -> bytes (host only: no launch)
        lib.ocvk_raisr_apply_generic_smem.argtypes = [_I] * 4
        lib.ocvk_raisr_apply_generic_smem.restype = ctypes.c_longlong
        # s, fl, nbucket, q, maxp -> bytes (host only: no launch)
        lib.ocvk_raisr_apply_split_smem.argtypes = [_I] * 5
        lib.ocvk_raisr_apply_split_smem.restype = ctypes.c_longlong
        _lib = lib
    return _lib


def launch(kernel: str, entry: str, device: torch.device, *args) -> None:
    """Call C entry point ``entry`` on ``device``'s current stream, raise on
    a CUDA error, and count one launch of ``kernel``."""
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, entry)(*args, stream)
    if rc != 0:
        msg = lib.ocvk_error_string(rc).decode()
        raise RuntimeError(f"{entry}: CUDA error {rc} ({msg})")
    LAUNCHES[kernel] += 1


def require_cuda_tensor(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of this dtype and rank."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}")
    if t.dtype != dtype or t.ndim != ndim:
        raise ValueError(
            f"{name} must be {dtype} with {ndim} dims, got {t.dtype} {tuple(t.shape)}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.numel() == 0:
        raise ValueError(f"{name} is empty")
