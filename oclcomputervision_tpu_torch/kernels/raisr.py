"""RAISR gradient hash and per-pixel filter select/apply, in plane space.

Ports of ``oclcomputervision_tpu/ops/pallas/raisr_pallas.py``:

- hash: ``hash_planes_pallas``. ``hash_planes`` is the plain PyTorch
  version, mirroring the XLA twin ``ops/raisr.hash_planes`` (atan2 angle,
  the blur taps summed in order); ``hash_planes_kernel`` wraps
  ``csrc/raisr_hash.cu`` (compiled for the shipped domain) and
  ``csrc/raisr_hash_generic.cu`` (any other config). Contract: >= 0.9999
  bucket agreement (only pixels within float rounding of a quantizer
  boundary may differ).
- apply: ``_apply_phase`` / ``apply_filters_planes``.
  ``apply_filters_planes`` is the plain version; ``apply_filters_planes_kernel``
  wraps ``csrc/raisr_apply.cu`` (filter length 11 at scales 2-4, the bank in
  shared memory), ``csrc/raisr_apply_generic.cu`` (any other config whose
  bank fits shared memory one phase at a time) and
  ``csrc/raisr_apply_split.cu`` (any config at all: a phase's bank split by
  tap range, ``split_plan``).
  Numerics of the TPU kernel: taps and bank rounded to bf16, products (exact
  in f32) summed in f32. The plain version and the kernels sum the taps in
  the same order.

Each wrapper takes the plain version for a CPU tensor and launches a kernel
for a CUDA tensor: the compiled form where the config lies in its domain,
the generic form otherwise (``hash_form``, ``apply_form``: chosen from the
config and shapes alone), each counted under its own name.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math
import weakref
from typing import NamedTuple

import numpy as np
import torch

from oclcomputervision_tpu_torch.kernels._build import launch, require_cuda_tensor
from oclcomputervision_tpu_torch.oracle.raisr import SOBEL_X, SOBEL_Y


def _num_buckets(cfg) -> int:
    return cfg.num_angle * cfg.num_strength * cfg.num_coherence


# ---------------------------------------------------------------------------
# Hash.
# ---------------------------------------------------------------------------


def _read_phases(planes, src_org, dr, dc, dst_org, rows, cols, s):
    """Shifted full-res read in plane space (``ops/raisr.py:_read_phases``):
    out[..., p, i, j] = the source value at full-res
    (s*(i - dst_org[0]) + a + dr, s*(j - dst_org[1]) + b + dc), p = a*s + b."""
    so_r, so_c = src_org
    do_r, do_c = dst_org
    outs = []
    for p in range(s * s):
        a, b = divmod(p, s)
        a2, ro = (a + dr) % s, (a + dr) // s
        b2, co = (b + dc) % s, (b + dc) // s
        r0 = so_r - do_r + ro
        c0 = so_c - do_c + co
        if r0 < 0 or c0 < 0:
            raise ValueError(f"plane read before the origin: {(r0, c0, dr, dc)}")
        outs.append(planes[..., a2 * s + b2, r0 : r0 + rows, c0 : c0 + cols])
    return torch.stack(outs, dim=-3)


def _eigen_bucket(a, b, d, cfg):
    """Structure tensor (a, b; b, d) -> (angle, strength, coherence) indices
    (``ops/raisr.py:_eigen_bucket``). Divisions by pi go through a device
    tensor: a Python-scalar divisor on CUDA becomes a reciprocal multiply."""
    pi = torch.tensor(math.pi, dtype=torch.float32, device=a.device)
    t = a + d
    det = a * d - b * b
    disc = torch.sqrt(torch.clamp(t * t / 4.0 - det, min=0.0))
    l1 = t / 2.0 + disc
    l2 = t / 2.0 - disc

    theta = torch.atan2(b, l1 - d)
    theta = torch.where(theta < 0, theta + pi, theta)

    sq1 = torch.sqrt(torch.clamp(l1, min=0.0))
    sq2 = torch.sqrt(torch.clamp(l2, min=0.0))
    denom = sq1 + sq2
    safe = torch.where(denom == 0, torch.ones_like(denom), denom)
    coherence = torch.where(denom != 0, (sq1 - sq2) / safe, torch.zeros_like(denom))

    angle_idx = torch.clamp(
        (theta / pi * cfg.num_angle).to(torch.int32), 0, cfg.num_angle - 1
    )
    strength_idx = sum((l1 >= q).to(torch.int32) for q in cfg.strength_quantizers)
    coherence_idx = sum(
        (coherence >= q).to(torch.int32) for q in cfg.coherence_quantizers
    )
    return angle_idx, strength_idx, coherence_idx


def hash_planes(y_planes: torch.Tensor, cfg, hp: int, h2p: int, w2p: int) -> torch.Tensor:
    """Plain version: luma planes [..., s*s, >= h2p + 2hp, >= w2p + 2hp]
    (origin (hp, hp)) -> bucket planes [..., s*s, h2p, w2p] int32 < 216.
    Sobel gradients, 9x9 separable structure-tensor blur, eigen analysis."""
    from oclcomputervision_tpu_torch.ops.raisr import _blur_k1

    s = cfg.scale
    g = cfg.gauss_len // 2
    bh = -(-g // s)  # plane halo of the blur stage

    def stencil3(kern):
        out = None
        for u in range(3):
            for v in range(3):
                cc = float(kern[u, v])
                if cc == 0.0:
                    continue
                term = cc * _read_phases(
                    y_planes, (hp, hp), u - 1, v - 1, (bh, bh),
                    h2p + 2 * bh, w2p + 2 * bh, s,
                )
                out = term if out is None else out + term
        return out

    gx = stencil3(SOBEL_X)
    gy = stencil3(SOBEL_Y)
    k1 = _blur_k1(cfg)
    t3 = torch.stack([gx * gx, gx * gy, gy * gy])

    vpass = None
    for u in range(cfg.gauss_len):
        term = float(k1[u]) * _read_phases(
            t3, (bh, bh), u - g, 0, (0, bh), h2p, w2p + 2 * bh, s
        )
        vpass = term if vpass is None else vpass + term
    hpass = None
    for u in range(cfg.gauss_len):
        term = float(k1[u]) * _read_phases(vpass, (0, bh), 0, u - g, (0, 0), h2p, w2p, s)
        hpass = term if hpass is None else hpass + term

    ai, si, ci = _eigen_bucket(hpass[0], hpass[1], hpass[2], cfg)
    return ((ai * cfg.num_strength + si) * cfg.num_coherence + ci).to(torch.int32)


HASH_TAPS = 9  # csrc/raisr_hash.cu's kTaps: the blur length it is compiled for
HASH_MAX_QUANT = 4  # csrc/raisr_hash.cu's kMaxQuant
HASH_SCALES = (2, 3, 4)
HASH_GENERIC_COLS = 128  # csrc/raisr_hash_generic.cu's kThreads: HR columns of a strip and its halo


def hash_form(cfg) -> str:
    """The hash kernel ``cfg`` runs, by its launch count's name: the compiled
    form (``csrc/raisr_hash.cu``) for blur length 9 at scales 2-4 with at
    most 4 quantizers of a kind, the generic form otherwise. Raises where
    the generic form's strip of HASH_GENERIC_COLS columns, less the blur's
    reach on each side, holds no output column of every phase
    (s + 2 (gauss_len // 2) > 128: from scale 19 at the widest blur the
    plane halo admits)."""
    s, g = cfg.scale, cfg.gauss_len // 2
    nq = max(len(cfg.strength_quantizers), len(cfg.coherence_quantizers))
    if cfg.gauss_len == HASH_TAPS and s in HASH_SCALES and nq <= HASH_MAX_QUANT:
        return "raisr_hash"
    if s + 2 * g > HASH_GENERIC_COLS:
        raise ValueError(f"the generic hash takes scale + 2 (gauss_len // 2) <= "
                         f"{HASH_GENERIC_COLS}, got scale {s} and gauss_len {cfg.gauss_len}")
    return "raisr_hash_generic"


class HashParams(ctypes.Structure):
    """The blur taps and quantizers as ``csrc/raisr_hash.cu``'s
    ``HashParams``, which the kernel takes by value (constant-bank operands)."""

    _fields_ = [
        ("k1", ctypes.c_float * HASH_TAPS),
        ("squant", ctypes.c_float * HASH_MAX_QUANT),
        ("cquant", ctypes.c_float * HASH_MAX_QUANT),
        ("na", ctypes.c_int),
        ("ns", ctypes.c_int),
        ("nc", ctypes.c_int),
    ]


def _hash_values(cfg):
    """f32 blur taps of ``_blur_k1``, strength and coherence quantizers."""
    from oclcomputervision_tpu_torch.ops.raisr import _blur_k1

    return (np.asarray(_blur_k1(cfg), np.float32),
            np.asarray(cfg.strength_quantizers, np.float32).reshape(-1),
            np.asarray(cfg.coherence_quantizers, np.float32).reshape(-1))


@functools.lru_cache(maxsize=8)
def hash_params(cfg) -> HashParams:
    """The compiled form's parameters for ``cfg``: f32 taps of ``_blur_k1``
    and f32 quantizers padded with NaN, which no value reaches (``x >= NaN``
    is false), so the kernel compares against all four. Raises for a config
    outside the compiled form's domain (``hash_form``)."""
    if hash_form(cfg) != "raisr_hash":
        raise ValueError(
            f"the compiled hash takes gauss_len {HASH_TAPS} at scales {HASH_SCALES} with at "
            f"most {HASH_MAX_QUANT} quantizers of a kind, got gauss_len {cfg.gauss_len} at "
            f"scale {cfg.scale}: the generic form runs it"
        )
    k1, sq, cq = _hash_values(cfg)
    pad = [math.nan] * HASH_MAX_QUANT
    prm = HashParams()
    prm.k1[:] = [float(v) for v in k1]
    prm.squant[:] = ([float(v) for v in sq] + pad)[:HASH_MAX_QUANT]
    prm.cquant[:] = ([float(v) for v in cq] + pad)[:HASH_MAX_QUANT]
    prm.na, prm.ns, prm.nc = cfg.num_angle, cfg.num_strength, cfg.num_coherence
    return prm


def hash_params_generic(cfg) -> np.ndarray:
    """The generic form's parameters for ``cfg``, as ``csrc/raisr_hash_generic.cu``
    reads them from device memory: the f32 taps of ``_blur_k1``, then the
    strength and then the coherence quantizers, unpadded."""
    return np.concatenate(_hash_values(cfg))


@functools.lru_cache(maxsize=8)
def _hash_params_on(cfg, device) -> torch.Tensor:
    return torch.from_numpy(hash_params_generic(cfg)).to(device)


def hash_planes_kernel(
    y_planes: torch.Tensor, cfg, hp: int, h2p: int, w2p: int
) -> torch.Tensor:
    """Wrapper: the plain version for a CPU tensor; for a CUDA tensor
    (contiguous [B, s*s, rows, wq] f32) the kernel ``hash_form(cfg)`` names."""
    if y_planes.device.type == "cpu":
        return hash_planes(y_planes, cfg, hp, h2p, w2p)
    require_cuda_tensor(y_planes, "y_planes", torch.float32, 4)
    s = cfg.scale
    g = cfg.gauss_len // 2
    nimg, ss, rows, wq = y_planes.shape
    if ss != s * s or rows < h2p + 2 * hp or wq < w2p + 2 * hp:
        raise ValueError(f"planes {tuple(y_planes.shape)} do not cover the plane "
                         f"geometry h2p={h2p}, w2p={w2p}, hp={hp} at scale {s}")
    if hp < -(-g // s) + 1 or nimg > 65535 or ss * rows * wq >= 2**31:
        raise ValueError(f"halo {hp} below the hash reach, or {nimg} images of "
                         f"{tuple(y_planes.shape[1:])}")
    out = torch.empty((nimg, ss, h2p, w2p), dtype=torch.int32, device=y_planes.device)
    if hash_form(cfg) == "raisr_hash":
        launch(
            "raisr_hash", "ocvk_raisr_hash", y_planes.device,
            y_planes.data_ptr(), out.data_ptr(), ctypes.addressof(hash_params(cfg)), nimg, s,
            hp, rows, wq, h2p, w2p,
        )
    else:
        prm = _hash_params_on(cfg, y_planes.device)
        launch(
            "raisr_hash_generic", "ocvk_raisr_hash_generic", y_planes.device,
            y_planes.data_ptr(), out.data_ptr(), prm.data_ptr(), nimg, s, cfg.gauss_len,
            len(cfg.strength_quantizers), len(cfg.coherence_quantizers), cfg.num_angle,
            cfg.num_strength, cfg.num_coherence, hp, rows, wq, h2p, w2p,
        )
    return out


# ---------------------------------------------------------------------------
# Apply.
# ---------------------------------------------------------------------------


def phase_rows(filters: torch.Tensor, cfg) -> torch.Tensor:
    """The bank as per-phase bf16 filter rows [s*s, buckets, fl*fl]: row
    [t, k] is filter ``k * s*s + t`` (the live block of
    ``raisr_pallas._phase_wmats``)."""
    fl = cfg.filter_len
    wall = filters.reshape(_num_buckets(cfg), cfg.num_pixel_type, fl * fl)
    return wall.permute(1, 0, 2).to(torch.bfloat16)


def apply_filters_planes(
    planes: torch.Tensor, bucket_planes: torch.Tensor, filters: torch.Tensor, cfg
) -> torch.Tensor:
    """Plain version: planes [nc*B, s*s, >= h2p + 2hp, >= w2p + 2hp] f32,
    bucket planes [B, s*s, h2p, w2p] int32, bank [num_filters, fl, fl] ->
    filtered planes [nc*B, s*s, h2p, w2p] f32. Image c*B + b reads bucket
    map b. A bucket outside [0, buckets) selects no filter and gives 0, as
    the TPU kernel's one-hot select does."""
    from oclcomputervision_tpu_torch.ops.raisr import _tap_tables, plane_halo

    s = cfg.scale
    fl = cfg.filter_len
    hp = plane_halo(fl, s, cfg.gauss_len)
    nimg = planes.shape[0]
    nb, ss, h2p, w2p = bucket_planes.shape
    if nimg % nb:
        raise ValueError(f"{nimg} plane images do not stack over {nb} bucket maps")
    nbk = _num_buckets(cfg)
    rows = phase_rows(filters, cfg).float()  # bf16-rounded, as f32
    taps = planes.to(torch.bfloat16).float()
    bk = bucket_planes.long().repeat(nimg // nb, 1, 1, 1)
    valid = (bk >= 0) & (bk < nbk)
    bk = torch.clamp(bk, 0, nbk - 1)
    out = torch.empty((nimg, ss, h2p, w2p), dtype=torch.float32, device=planes.device)
    for t in range(ss):
        py, px = divmod(t, s)
        tap_plane, tap_off = _tap_tables(fl, s, py, px, hp)
        bt = bk[:, t]
        acc = torch.zeros((nimg, h2p, w2p), dtype=torch.float32, device=planes.device)
        for q, (p, (ro, co)) in enumerate(zip(tap_plane, tap_off)):
            coef = rows[t, :, q][bt]
            acc = acc + coef * taps[:, p, ro : ro + h2p, co : co + w2p]
        out[:, t] = torch.where(valid[:, t], acc, torch.zeros_like(acc))
    return out


BANK_ROW_STRIDE = 122  # bf16 per filter row of the compiled apply: 61 words, an odd count
APPLY_TAPS = 11  # csrc/raisr_apply.cu's kFL: the filter length it is compiled for
APPLY_SCALES = (2, 3, 4)
APPLY_SMEM_LIMIT = 232448  # bytes of shared memory a block may take on the H100


def apply_smem(s: int, nbucket: int) -> int:
    """Dynamic shared memory of ``csrc/raisr_apply.cu``'s launch at scale
    ``s`` (2-4): its resident phases' banks, then the bf16 tile of s*s planes
    (that file's ``launch``)."""
    phases = {2: 4, 3: 3, 4: 2}[s]
    reach = -(-(APPLY_TAPS // 2) // s)
    bank_words = -(-phases * nbucket * (BANK_ROW_STRIDE // 2) // 4) * 4
    return 4 * bank_words + 2 * s * s * (16 + 2 * reach) * (64 + 8)


# csrc/raisr_apply_generic.cu's tile (plane rows and columns) and its most
# resident phases (256 threads each, 1024 a block)
APPLY_TILE = (16, 64)
APPLY_MAX_PHASES = 4


def odd_words(taps: int) -> int:
    """32-bit words per bank row of ``taps`` bf16 weights and zero padding
    to an odd word count ((taps + 1) / 2, one word more if that is even), so
    that one tap of rows that differ mod 32 lies in different shared-memory
    banks (``csrc/raisr_apply_tile.cuh``'s ``odd_words``)."""
    w = (taps + 1) // 2
    return w if w % 2 else w + 1


def generic_row_words(fl: int) -> int:
    """32-bit words per filter row of the generic apply's bank: fl*fl bf16
    and zero padding to an odd word count ((fl*fl + 1) / 2 for odd fl, one
    word more for even fl)."""
    return odd_words(fl * fl)


def tile_plane_words(s: int, fl: int) -> int:
    """Words of one plane of the generic apply forms' staged bf16 tile
    (``csrc/raisr_apply_tile.cuh``'s ``tile_geometry``): APPLY_TILE plus the
    filter's reach R on each side, rows of 32 + padL words (padL = R rounded
    up to even) padded to an odd pitch."""
    reach = -(-(fl // 2) // s)
    half = APPLY_TILE[1] // 2 + (reach + 1) // 2 * 2
    pitch = half + 1 if half % 2 == 0 else half + 2
    return (APPLY_TILE[0] + 2 * reach) * pitch


def generic_apply_smem(s: int, fl: int, nbucket: int, phases: int) -> int:
    """Dynamic shared memory of the generic apply's launch with ``phases``
    resident phases (that file's ``smem_bytes``): their banks (rounded up to
    16 bytes), their tap tables (a word offset and a shift per tap, padded
    to an even tap count) and the tile."""
    bank = -(-phases * nbucket * generic_row_words(fl) // 4) * 4
    taps = phases * -(-fl * fl // 2) * 4
    return 4 * (bank + taps + s * s * tile_plane_words(s, fl))


def generic_apply_phases(s: int, fl: int, nbucket: int) -> int:
    """Resident phases of a generic apply block: the most (at most
    APPLY_MAX_PHASES and s*s) whose banks fit beside the tile in a block's
    shared memory, evened out over the sets of phases that cover all s*s;
    0 when not even one phase fits (the split form runs the config)."""
    most = 0
    for p in range(1, min(APPLY_MAX_PHASES, s * s) + 1):
        if generic_apply_smem(s, fl, nbucket, p) <= APPLY_SMEM_LIMIT:
            most = p
    if not most:
        return 0
    nsets = -(-(s * s) // most)
    return -(-(s * s) // nsets)


def generic_tap_table(s: int, fl: int) -> np.ndarray:
    """int32 [s*s, fl*fl, 3]: per phase t = (py, px) and tap q = ti*fl + tj,
    the plane a*s + b it reads and its plane row and column offset
    (floor((py - m + ti) / s), floor((px - m + tj) / s)), m = fl // 2: the
    generic apply's taps, ``ops/raisr._tap_tables`` without the halo."""
    m = fl // 2
    t = np.arange(s * s)
    vr = (t // s)[:, None] - m + np.arange(fl)[None, :]  # [t, ti]
    vc = (t % s)[:, None] - m + np.arange(fl)[None, :]  # [t, tj]
    out = np.empty((s * s, fl, fl, 3), np.int32)
    out[..., 0] = (vr % s)[:, :, None] * s + (vc % s)[:, None, :]
    out[..., 1] = (vr // s)[:, :, None]
    out[..., 2] = (vc // s)[:, None, :]
    return out.reshape(s * s, fl * fl, 3)


@functools.lru_cache(maxsize=8)
def _tap_table_on(s: int, fl: int, device) -> torch.Tensor:
    return torch.from_numpy(generic_tap_table(s, fl)).to(device)


SPLIT_HEAD = 4  # csrc/raisr_apply_split.cu's kHead: ints of a plan record before its plane list
# the most dynamic shared memory that lets two split-apply blocks share an
# SM: 2 (bytes + 1 KB the SM keeps per block) <= its 228 KB
SPLIT_PAIR_SMEM = 233472 // 2 - 1024


class SplitPlan(NamedTuple):
    """How ``csrc/raisr_apply_split.cu`` cuts a config's bank: ``nsplit``
    splits of ``q`` consecutive taps (q even; the last split may hold
    fewer), ``odd_words(q)`` words a row, and a tile of at most ``maxp``
    planes. ``table``: int32 [s*s, nsplit, SPLIT_HEAD + maxp + 3 q], per
    phase and split the record the kernel reads: the number of planes the
    split's taps read, its first tap, its tap count, 0, those planes (the
    image's plane index, ascending, zero padding) and per tap its staged
    plane (an index into that list), row offset and column offset
    (``generic_tap_table``'s offsets), zero padding."""

    nsplit: int
    q: int
    maxp: int
    table: np.ndarray


def split_apply_smem(s: int, fl: int, nbucket: int, q: int, maxp: int) -> int:
    """Dynamic shared memory of the split apply's launch (that file's
    ``smem_bytes``): a split's rows (rounded up to 16 bytes), its tap table
    (a word offset and a shift per tap), the plane list (rounded up to 4)
    and a tile of ``maxp`` planes."""
    bank = -(-nbucket * odd_words(q) // 4) * 4
    return 4 * (bank + 2 * q + -(-maxp // 4) * 4 + maxp * tile_plane_words(s, fl))


def _split_planes(plane_of_tap: np.ndarray, q: int) -> np.ndarray:
    """[s*s, nsplit, q] the plane each tap of each split reads, -1 past the last tap."""
    ss, ntap = plane_of_tap.shape
    nsplit = -(-ntap // q)
    padded = np.full((ss, nsplit * q), -1, np.int64)
    padded[:, :ntap] = plane_of_tap
    return padded.reshape(ss, nsplit, q)


def _distinct_planes(split_planes: np.ndarray) -> np.ndarray:
    """Distinct planes (>= 0) of each split: [s*s, nsplit]."""
    v = np.sort(split_planes, axis=-1)
    new = np.ones(v.shape, bool)
    new[..., 1:] = v[..., 1:] != v[..., :-1]
    return (new & (v >= 0)).sum(-1)


@functools.lru_cache(maxsize=32)
def split_plan(s: int, fl: int, nbucket: int, nsplit: int | None = None) -> SplitPlan:
    """The split apply's plan: the fewest splits (of an even tap count q)
    whose rows, tap table, plane list and tile let two blocks share an SM
    (SPLIT_PAIR_SMEM), else the fewest that fit one block's shared memory;
    or exactly ``nsplit`` (for timing other plans). Each split's tile holds
    only the planes its taps read, so some q fits every config: at q = 2 a
    split reads at most two planes. Raises when even that does not fit (a
    bucket count near 56,000) or ``nsplit`` does not."""
    ntap = fl * fl
    taps = generic_tap_table(s, fl)
    counts = range(1, -(-ntap // 2) + 1) if nsplit is None else (nsplit,)
    fits = None  # the fewest splits that fit a block: (q, maxp)
    tried = set()
    for n in counts:
        q = 2 * -(-ntap // (2 * n))
        if q in tried:
            continue
        tried.add(q)
        maxp = int(_distinct_planes(_split_planes(taps[..., 0], q)).max())
        smem = split_apply_smem(s, fl, nbucket, q, maxp)
        if smem <= APPLY_SMEM_LIMIT and fits is None:
            fits = q, maxp
        if smem <= SPLIT_PAIR_SMEM and nsplit is None:
            fits = q, maxp
            break
    if fits is None:
        raise ValueError(f"no split of scale {s}, filter_len {fl} and {nbucket} buckets"
                         f"{'' if nsplit is None else f' into {nsplit}'} fits {APPLY_SMEM_LIMIT} "
                         f"bytes of shared memory")
    q, maxp = fits
    nsp = -(-ntap // q)
    table = np.zeros((s * s, nsp, SPLIT_HEAD + maxp + 3 * q), np.int32)
    for t in range(s * s):
        for k in range(nsp):
            tq = taps[t, k * q : (k + 1) * q]
            used = np.unique(tq[:, 0])
            table[t, k, :3] = (len(used), k * q, len(tq))
            table[t, k, SPLIT_HEAD : SPLIT_HEAD + len(used)] = used
            staged = np.stack([np.searchsorted(used, tq[:, 0]), tq[:, 1], tq[:, 2]], -1)
            table[t, k, SPLIT_HEAD + maxp : SPLIT_HEAD + maxp + 3 * len(tq)] = staged.reshape(-1)
    return SplitPlan(nsp, q, maxp, table)


@functools.lru_cache(maxsize=8)
def _split_table_on(s: int, fl: int, nbucket: int, device) -> torch.Tensor:
    return torch.from_numpy(split_plan(s, fl, nbucket).table).to(device)


def apply_form(cfg, w2p: int) -> str:
    """The apply kernel ``cfg`` runs, by its launch count's name: the
    compiled form (``csrc/raisr_apply.cu``) for filter length 11 at scales
    2-4 when its resident banks fit a block's shared memory and the plane
    width is a multiple of 4 (every plane geometry's is); otherwise the
    generic form (any width) when one phase's bank fits beside its tile of
    all s*s planes, and the split form (``csrc/raisr_apply_split.cu``, a
    phase's bank cut by tap range, ``split_plan``) for every other config."""
    s, fl, nbk = cfg.scale, cfg.filter_len, _num_buckets(cfg)
    if (fl == APPLY_TAPS and s in APPLY_SCALES and w2p % 4 == 0
            and apply_smem(s, nbk) <= APPLY_SMEM_LIMIT):
        return "raisr_apply"
    return "raisr_apply_generic" if generic_apply_phases(s, fl, nbk) else "raisr_apply_split"


# laid-out banks, newest last: key -> (weak reference to the filters, bank)
_BANKS: collections.OrderedDict = collections.OrderedDict()
_BANKS_KEPT = 8


def _bank_rows(filters: torch.Tensor, cfg, stride: int = BANK_ROW_STRIDE,
               split: int | None = None) -> tuple[torch.Tensor, int]:
    """The bank as the apply kernels read it: per-phase bf16 rows
    [s*s, buckets, stride], ``phase_rows`` followed by zero padding. The
    compiled form's stride of 122 and the generic form's 2 *
    ``generic_row_words`` (odd word counts) put one tap of different rows
    on different shared-memory banks. With ``split`` = q, the split form's
    bank [nsplit, s*s, buckets, stride]: split k holds taps [k q, (k + 1) q)
    of every row, then zero padding.

    Built once per bank: the result is kept for this very tensor (its
    storage address, version counter, device and the scale) and reused until
    the tensor is changed in place or goes away."""
    key = (filters.data_ptr(), filters._version, filters.device, cfg.scale,
           cfg.filter_len, _num_buckets(cfg), stride, split)
    hit = _BANKS.get(key)
    if hit is not None and hit[0]() is filters:
        _BANKS.move_to_end(key)
        return hit[1], stride
    rows = phase_rows(filters, cfg)
    ntap = rows.shape[-1]
    q = ntap if split is None else split
    if q > stride:
        raise ValueError(f"{q} taps do not fit a row of {stride}")
    nsplit = -(-ntap // q)
    bank = torch.zeros((nsplit,) + rows.shape[:2] + (stride,), dtype=torch.bfloat16,
                       device=rows.device)
    for k in range(nsplit):
        part = rows[..., k * q : (k + 1) * q]
        bank[k, ..., : part.shape[-1]] = part
    if split is None:
        bank = bank[0]
    _BANKS[key] = (weakref.ref(filters), bank)
    while len(_BANKS) > _BANKS_KEPT:
        _BANKS.popitem(last=False)
    return bank, stride


def apply_filters_planes_kernel(
    planes: torch.Tensor, bucket_planes: torch.Tensor, filters: torch.Tensor, cfg
) -> torch.Tensor:
    """Wrapper: the plain version for CPU tensors; for CUDA tensors one
    launch for every image and phase of the kernel ``apply_form`` names."""
    from oclcomputervision_tpu_torch.ops.raisr import plane_halo

    if planes.device.type == "cpu":
        return apply_filters_planes(planes, bucket_planes, filters, cfg)
    require_cuda_tensor(planes, "planes", torch.float32, 4)
    require_cuda_tensor(bucket_planes, "bucket_planes", torch.int32, 4)
    s = cfg.scale
    fl = cfg.filter_len
    hp = plane_halo(fl, s, cfg.gauss_len)
    nimg, ss, rows, wq = planes.shape
    nb, ssb, h2p, w2p = bucket_planes.shape
    if bucket_planes.device != planes.device or filters.device != planes.device:
        raise ValueError("planes, bucket_planes and filters must share a device")
    if filters.dtype != torch.float32 or filters.numel() != cfg.num_filters * fl * fl:
        raise ValueError(f"filters must be f32 [{cfg.num_filters}, {fl}, {fl}]")
    if ss != s * s or ssb != ss or nimg % nb:
        raise ValueError(f"planes {tuple(planes.shape)} and buckets "
                         f"{tuple(bucket_planes.shape)} do not match at scale {s}")
    if rows < h2p + 2 * hp or wq < w2p + 2 * hp:
        raise ValueError(f"planes {tuple(planes.shape)} lack the {hp}-plane halo")
    form = apply_form(cfg, w2p)
    nbk = _num_buckets(cfg)
    out = torch.empty((nimg, ss, h2p, w2p), dtype=torch.float32, device=planes.device)
    if form == "raisr_apply_generic":
        bank, stride = _bank_rows(filters, cfg, 2 * generic_row_words(fl))
        launch(
            form, f"ocvk_{form}", planes.device,
            planes.data_ptr(), bucket_planes.data_ptr(), bank.data_ptr(),
            _tap_table_on(s, fl, planes.device).data_ptr(), out.data_ptr(),
            nimg, nb, s, fl, hp, rows, wq, h2p, w2p, nbk, stride // 2,
            generic_apply_phases(s, fl, nbk),
        )
        return out
    if form == "raisr_apply_split":
        plan = split_plan(s, fl, nbk)
        bank, stride = _bank_rows(filters, cfg, 2 * odd_words(plan.q), plan.q)
        launch(
            form, f"ocvk_{form}", planes.device,
            planes.data_ptr(), bucket_planes.data_ptr(), bank.data_ptr(),
            _split_table_on(s, fl, nbk, planes.device).data_ptr(), out.data_ptr(),
            nimg, nb, s, fl, hp, rows, wq, h2p, w2p, nbk, stride // 2, plan.nsplit, plan.q,
            plan.maxp,
        )
        return out
    bank, stride = _bank_rows(filters, cfg)
    launch(
        form, f"ocvk_{form}", planes.device,
        planes.data_ptr(), bucket_planes.data_ptr(), bank.data_ptr(), out.data_ptr(),
        nimg, nb, s, fl, hp, rows, wq, h2p, w2p, nbk, stride,
    )
    return out
