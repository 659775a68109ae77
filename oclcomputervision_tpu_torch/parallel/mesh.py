"""Multi-process scaling on ``torch.distributed``: a device mesh over the
process group and the sharding strategies of the JAX package's
``parallel/mesh.py``, on the port's ops and kernels.

- data parallelism (dp): ``data_parallel`` splits a batch over a mesh axis;
- spatial parallelism (sp): one image split by rows (``histeq_global_sharded``,
  ``histeq_local_sharded``, ``motion_fast_sharded``, ``motion_exact_sharded``,
  ``raisr_upsample_sharded``): each rank works on its rows and the few rows
  its neighbours send it;
- tensor parallelism (tp): ``raisr_train_step`` solves the RAISR buckets
  split over a mesh axis.

SPMD contract (a ``shard_map`` call's): every rank of the process group calls
a strategy with the same global array and gets the global result. Each rank
takes its own rows (or batch) of the array, computes only from them and from
what the collectives deliver, then gathers the output from every rank.

Every collective goes through ``_collective``: a sum, a gather along dim 0,
or the exchange of edge rows with the row neighbours (the JAX package's two
``ppermute`` shifts; zeros where there is no neighbour, as ``ppermute``
delivers).

The processes are started by ``parallel/launch.py`` (or any launcher that
initialises ``torch.distributed``); ``make_mesh`` raises without a process
group.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from oclcomputervision_tpu_torch._device import as_device, as_tensor, require_cuda
from oclcomputervision_tpu_torch.kernels import histeq as khisteq
from oclcomputervision_tpu_torch.kernels import localeq as klocaleq
from oclcomputervision_tpu_torch.ops import histeq as ops_histeq
from oclcomputervision_tpu_torch.ops import motion as ops_motion
from oclcomputervision_tpu_torch.ops import raisr as ops_raisr


class Mesh:
    """The ranks of the process group laid out row-major over named axes:
    ``shape`` maps each axis to its size (as a JAX ``Mesh.shape``),
    ``coords`` this rank's index along each, ``groups`` the process group of
    the ranks that share this rank's place on every other axis, and
    ``device`` the device this rank computes on."""

    def __init__(self, shape: Tuple[int, ...], axis_names: Sequence[str], device: torch.device):
        rank = dist.get_rank()
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, shape))
        self.coords = dict(zip(self.axis_names, (int(c) for c in np.unravel_index(rank, shape))))
        self.device = device
        grid = np.arange(math.prod(shape)).reshape(shape)
        self.groups = {}
        for k, name in enumerate(self.axis_names):
            # every rank creates every group, in the same order
            for line in np.moveaxis(grid, k, -1).reshape(-1, shape[k]).tolist():
                group = dist.new_group(line)
                if rank in line:
                    self.groups[name] = group


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = ("data",),
    device=None,
) -> Mesh:
    """A mesh over the initialised process group (default: one 'data' axis
    over every rank). The axis sizes must multiply to the world size.

    ``device`` None means the card: CUDA device rank % device_count (every
    rank on the one card of a one-card machine); 'cpu' runs the plain
    versions, another device is taken as given."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs an initialised torch.distributed process group "
            "(python -m oclcomputervision_tpu_torch.parallel.launch starts one)"
        )
    world = dist.get_world_size()
    shape = (world,) if shape is None else tuple(int(n) for n in shape)
    if len(shape) != len(tuple(axis_names)) or math.prod(shape) != world:
        raise ValueError(
            f"mesh {shape} over axes {tuple(axis_names)} does not lay out the {world} ranks"
        )
    if device is None:
        require_cuda()
        dev = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    else:
        dev = as_device(device)
    return Mesh(shape, axis_names, dev)


def _collective(op: str, x: torch.Tensor, mesh: Mesh, axis: str, rows: int = 0):
    """Run one collective over ``axis``'s process group:

    - 'sum': the all-reduced sum of ``x`` (``x`` is left as it is);
    - 'gather': every rank's ``x`` concatenated along dim 0, in axis order;
    - 'halo': (the last ``rows`` rows of the previous rank's ``x``, the first
      ``rows`` rows of the next rank's), zeros where there is no neighbour.
      The edge rows are few, so both go to every rank in one gather.

    When the group's backend cannot take CUDA tensors (gloo), the payload is
    staged through host memory: copied to the host, reduced or gathered
    there, and copied back. The computing around it stays on the device, and
    the backend is never switched.
    """
    group = mesh.groups[axis]
    staged = x.device.type == "cuda" and dist.get_backend(group) == "gloo"
    n = mesh.shape[axis]
    buf = x.cpu() if staged else x
    if op == "sum":
        buf = buf.clone() if buf is x else buf  # all_reduce works in place
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        out = buf
    elif op in ("gather", "halo"):
        if op == "halo":
            buf = torch.cat([buf[:rows], buf[buf.shape[0] - rows :]])
        parts = [torch.empty_like(buf) for _ in range(n)]
        dist.all_gather(parts, buf.contiguous(), group=group)
        if op == "gather":
            out = torch.cat(parts)
        else:
            i = mesh.coords[axis]
            zeros = torch.zeros_like(buf[:rows])
            above = parts[i - 1][rows:] if i > 0 else zeros
            below = parts[i + 1][:rows] if i < n - 1 else zeros
            return tuple(t.to(x.device) for t in (above, below))
    else:
        raise ValueError(f"unknown collective {op!r}")
    return out.to(x.device)


def _local(x, mesh: Mesh, axis: str) -> torch.Tensor:
    """This rank's block of the global array ``x`` along dim 0 (its index
    on ``axis``), contiguous on the mesh's device; only that block moves."""
    n, i = mesh.shape[axis], mesh.coords[axis]
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
    if x.shape[0] % n:
        raise ValueError(f"rows {x.shape[0]} not divisible by mesh axis {n}")
    b = x.shape[0] // n
    part = x[i * b : (i + 1) * b]
    if isinstance(part, torch.Tensor):
        return part.to(mesh.device).contiguous()
    return torch.from_numpy(np.ascontiguousarray(part)).to(mesh.device)


def _gather_tree(out, mesh: Mesh, axis: str):
    if isinstance(out, (tuple, list)):
        return type(out)(_gather_tree(o, mesh, axis) for o in out)
    return _collective("gather", out, mesh, axis)


def data_parallel(fn, mesh: Mesh, axis: str = "data"):
    """Shard a batch-first op over the mesh's ``axis``.

    ``fn`` maps [b, ...] tensors to [b, ...] tensors (or a tuple or list of
    them). The wrapper takes global batches divisible by the axis size,
    runs ``fn`` on this rank's shard of each on the mesh's device, and
    returns the gathered global outputs."""

    def sharded(*args):
        return _gather_tree(fn(*(_local(a, mesh, axis) for a in args)), mesh, axis)

    return sharded


def _rows_of(gray, what: str) -> Tuple[int, int]:
    shape = tuple(gray.shape)
    if len(shape) != 2:
        raise ValueError(f"{what} takes one [H, W] image, got {shape}")
    return shape


def histeq_global_sharded(
    gray,
    mesh: Mesh,
    axis: str = "data",
    alpha: float = 1.0,
    punch: float = 0.05,
    clip: float = 2.0,
):
    """Row-sharded global histeq of a uint8 [H, W] image.

    Each rank histograms its rows (the hist256 kernel, one histogram per
    row, so every count is exact), one all-reduce of the 256 counts builds
    the image's histogram, every rank computes the same LUT as the
    single-device op and applies it to its rows (the apply_lut kernel).
    Equal to ``ops.histeq_global`` bit for bit."""
    _rows_of(gray, "histeq_global_sharded")
    g = _local(gray, mesh, axis)
    if g.dtype != torch.uint8:
        raise TypeError(f"expected uint8 pixels, got {g.dtype}")
    counts = khisteq.hist256_kernel(g).to(torch.int64).sum(0, keepdim=True)
    hist = _collective("sum", counts, mesh, axis).to(torch.float32)
    lut = ops_histeq.calc_transfer_func(hist, alpha, punch, clip).to(torch.uint8)
    out = khisteq.apply_lut_kernel(g.reshape(1, -1), lut.contiguous()).reshape(g.shape)
    return _collective("gather", out, mesh, axis)


def histeq_local_sharded(
    gray,
    mesh: Mesh,
    axis: str = "data",
    alpha: float = 0.5,
    punch: float = 0.05,
    clip: float = 3.0,
    blockshape: Tuple[int, int] = (256, 256),
    clahe_clip: float = 0.0,
):
    """Row-sharded local-block (CLAHE-style) histeq of a uint8 [H, W] image.

    Each rank histograms and solves the LUTs of its own block rows (the
    hist_tiles kernel), one all-gather builds the [nby, nbx, 256] LUT grid,
    and each rank blends its rows against it (the blend_blocks kernel with
    its first image row as the row origin). The blend reads only the pixel
    and its four LUTs, so no pixel halo is exchanged. Equal to
    ``ops.histeq_local_block`` bit for bit.

    Requires the rows to split into whole block rows per rank:
    H % (ranks * blockshape[0]) == 0."""
    bh, bw = blockshape
    n = mesh.shape[axis]
    h, w = _rows_of(gray, "histeq_local_sharded")
    if h % (n * bh):
        raise ValueError(f"rows {h} not divisible by ndev*bh = {n}*{bh}")
    g = _local(gray, mesh, axis)
    if g.dtype != torch.uint8:
        raise TypeError(f"expected uint8 pixels, got {g.dtype}")
    grid = klocaleq.hist_tiles_kernel(g[None], tuple(blockshape))
    if clahe_clip > 0:
        grid = ops_histeq.clip_histogram(grid, clahe_clip)
    m_loc = ops_histeq.calc_transfer_func(grid, alpha, punch, clip)[0]
    m_all = _collective("gather", m_loc, mesh, axis)
    y0 = mesh.coords[axis] * (h // n)
    out = klocaleq.blend_blocks_kernel(g[None], m_all[None].contiguous(), tuple(blockshape), y0)[0]
    return _collective("gather", out, mesh, axis)


def _motion_bands(gray0, gray1, mesh: Mesh, axis: str, halo: int, what: str):
    """Both frames' row bands of this rank, each grown by ``halo`` rows from
    its neighbours (zeros beyond the image): (band0, band1, r0, h, w)."""
    n = mesh.shape[axis]
    h, w = _rows_of(gray0, what)
    if tuple(gray1.shape) != (h, w):
        raise ValueError(f"{what}: frames differ, {(h, w)} vs {tuple(gray1.shape)}")
    if h % n:
        raise ValueError(f"rows {h} not divisible by mesh axis {n}")
    h_loc = h // n
    if halo > h_loc:
        raise ValueError(f"halo {halo} exceeds shard rows {h_loc}; use fewer devices")
    both = torch.stack([_local(gray0, mesh, axis), _local(gray1, mesh, axis)], dim=1)
    if both.dtype != torch.uint8:
        raise TypeError(f"{what} expects uint8 frames, got {both.dtype}")
    above, below = _collective("halo", both, mesh, axis, halo)
    ext = torch.cat([above, both, below])  # [h_loc + 2 halo, 2, w]
    r0 = mesh.coords[axis] * h_loc - halo
    return ext[:, 0].contiguous(), ext[:, 1].contiguous(), r0, h, w


def motion_fast_sharded(
    gray0,
    gray1,
    mesh: Mesh,
    axis: str = "data",
    search_size: int = 15,
    patch_size: int = 5,
    costfn: str = "sad",
):
    """Row-sharded fast-mode dense motion estimation, unseeded.

    Each rank takes its rows of both frames and ``fast_halo_rows()`` rows
    from each neighbour (17 at 15/5: how far a band edge's error creeps in
    over the rounds), runs the band iteration
    (``ops.motion._fast_residual_band``: the round and median kernels) and
    keeps its own rows. Equal to ``ops.estimate_motion_vector(...,
    method='fast')`` bit for bit. Returns float32 [H, W, 2]."""
    hh = ops_motion.fast_halo_rows(search_size, patch_size)
    f0, f1, r0, h, w = _motion_bands(gray0, gray1, mesh, axis, hh, "motion_fast_sharded")
    res = ops_motion._fast_residual_band(f0, f1, r0, h, w, search_size, patch_size, costfn)
    return _collective("gather", res[hh : res.shape[0] - hh].contiguous(), mesh, axis)


def motion_exact_sharded(
    gray0,
    gray1,
    mesh: Mesh,
    axis: str = "data",
    search_size: int = 15,
    patch_size: int = 5,
    costfn: str = "sad",
):
    """Row-sharded exact dense motion estimation, unseeded.

    Each rank takes its rows of both frames and ``exact_halo_rows()`` rows
    from each neighbour (10 at 15/5: the patch's reach plus the farthest
    displacement the steps reach), runs the exact search on the band (the
    me_exact kernel; the zeros beyond the image are the search's own zero
    fill) and keeps its own rows. Every output pixel reads only frame rows
    within that reach, so the result equals
    ``ops.estimate_motion_vector(..., method='exact')`` bit for bit.
    Returns float32 [H, W, 2]."""
    hh = ops_motion.exact_halo_rows(search_size, patch_size)
    f0, f1, _, _, _ = _motion_bands(gray0, gray1, mesh, axis, hh, "motion_exact_sharded")
    res = ops_motion._estimate(
        f0[None], f1[None], None, search_size, patch_size, "fixed", "exact", costfn, "auto", "auto"
    )[0]
    return _collective("gather", res[hh : res.shape[0] - hh].contiguous(), mesh, axis)


def raisr_train_step(
    patches,
    targets,
    fidx,
    num_filters: int,
    filter_len: int,
    mesh: Mesh,
    dp_axis: str = "dp",
    tp_axis: str = "tp",
    chunk: int = 256,
    ridge: float = 0.03,
) -> torch.Tensor:
    """One distributed RAISR training step on a (dp, tp) mesh.

    dp: the training pixels are split over ``dp_axis``; each rank
    accumulates its shard's normal equations (``models.raisr
    .accumulate_normal_eq``), and one all-reduce over dp sums G, r and the
    counts. tp: each rank solves num_filters / tp buckets
    (``solve_filters``) and an all-gather over tp assembles the bank.
    Returns the filter bank [num_filters, filter_len, filter_len] float32;
    the shards' sums are added in another order than one device's, so it
    matches the single-device bank to float32 tolerance."""
    from oclcomputervision_tpu_torch.models.raisr import accumulate_normal_eq, solve_filters

    tp, dp = mesh.shape[tp_axis], mesh.shape[dp_axis]
    if num_filters % tp:
        raise ValueError(f"num_filters {num_filters} not divisible by tp {tp}")
    if tuple(patches.shape)[0] % dp:
        raise ValueError(f"rows {patches.shape[0]} not divisible by mesh axis {dp}")
    p = _local(patches, mesh, dp_axis).to(torch.float32)
    t = _local(targets, mesh, dp_axis).to(torch.float32)
    f = _local(fidx, mesh, dp_axis)
    g, r, cnt = accumulate_normal_eq(p, t, f, num_filters, chunk)
    d = g.shape[1]
    total = _collective("sum", torch.cat([g.reshape(-1), r.reshape(-1), cnt]), mesh, dp_axis)
    g = total[: num_filters * d * d].reshape(num_filters, d, d)
    r = total[num_filters * d * d : -num_filters].reshape(num_filters, d)
    cnt = total[-num_filters:]
    nb = num_filters // tp
    lo = mesh.coords[tp_axis] * nb
    fs = solve_filters(g[lo : lo + nb], r[lo : lo + nb], cnt[lo : lo + nb], filter_len, ridge)
    return _collective("gather", fs.contiguous(), mesh, tp_axis)


def raisr_upsample_sharded(
    lr,
    filters,
    cfg,
    mesh: Mesh,
    axis: str = "data",
    halo: int = 8,
):
    """Row-sharded RAISR inference (fidelity='full') of a uint8 [H, W] image.

    Each rank takes its LR rows and ``halo`` rows from each neighbour
    (zeros beyond the image, which are never read: the image's stencil
    clamps to its own edge rows), upsamples the band at the image's
    coordinates (``ops.raisr._raisr_band``: the upscale's row stencil
    rebased into the band, then the hash and apply kernels) and keeps its
    s * rows HR rows. The halo must cover the HR receptive field
    (``ops.raisr.min_band_halo``: 6 LR rows at the shipped x2 config).
    Equal to ``ops.raisr.raisr_upsample`` bit for bit."""
    n = mesh.shape[axis]
    h, _ = _rows_of(lr, "raisr_upsample_sharded")
    if h % n:
        raise ValueError(f"rows {h} not divisible by mesh axis {n}")
    h_loc = h // n
    if halo > h_loc:
        raise ValueError(f"halo {halo} exceeds shard rows {h_loc}; use fewer devices")
    need = ops_raisr.min_band_halo(cfg)
    if halo < need:
        raise ValueError(f"halo {halo} is below the {need} LR rows the upscale and filters reach")
    if cfg.fidelity != "full":
        raise ValueError(f"raisr_upsample_sharded runs fidelity='full', got {cfg.fidelity!r}")
    x = _local(lr, mesh, axis)
    if x.dtype != torch.uint8:
        raise TypeError(f"expected uint8 pixels, got {x.dtype}")
    above, below = _collective("halo", x, mesh, axis, halo)
    i = mesh.coords[axis]
    band = torch.cat([above, x, below])
    bank = as_tensor(filters, mesh.device).to(torch.float32)
    hr = ops_raisr._raisr_band(band, i * h_loc - halo, h, bank, cfg)
    s = cfg.scale
    return _collective("gather", hr[s * halo : s * (halo + h_loc)].contiguous(), mesh, axis)
