"""The rank body of tests/test_torch_parallel.py: one run of every entry point
of ``oclcomputervision_tpu_torch.parallel`` (and ``EnhancePipeline.sharded``
and the dry run's rank body) on a 4-rank gloo group on the CPU, each also on
inputs whose rows (or batch entries) outside the rank's shard are poisoned
with noise of that rank's own. Rank 0 writes the inputs and every gathered
result to one .npz:

    python -m oclcomputervision_tpu_torch.parallel.launch --nproc 4 --device cpu \
        tests/torch_parallel_ranks.py:main OUT.npz

Imports neither JAX nor pytest: the test holds the .npz against the port's
single-device ops and the JAX package's sharded functions.
"""

import numpy as np
import torch
import torch.distributed as dist

from oclcomputervision_tpu_torch import ops, parallel
from oclcomputervision_tpu_torch.entry import dryrun_rank
from oclcomputervision_tpu_torch.models import EnhanceConfig, EnhancePipeline, RaisrModel
from oclcomputervision_tpu_torch.models.raisr import _training_arrays
from oclcomputervision_tpu_torch.utils import asset_path, load_gray
from oclcomputervision_tpu_torch.utils.config import RaisrConfig

RANKS = 4
BLOCK = (32, 32)  # local histeq: one block row per rank on 128 rows
PIPE = EnhanceConfig(equalize="global", superres="raisr", resize_to=(40, 56), pyramid_depth=2)


def inputs() -> dict:
    """The global arrays, the same on every rank (and in the test)."""
    rng = np.random.default_rng(0)
    lenna = load_gray("lenna.png")
    f10, f11 = load_gray("frame10.png"), load_gray("frame11.png")
    batch = np.stack([np.roll(lenna[200:232, 200:248], 7 * i, axis=1) for i in range(8)])
    return {
        "gray": np.ascontiguousarray(lenna[100:196, 160:224]),  # 96 x 64
        "local": rng.integers(0, 256, (128, 96), dtype=np.uint8),
        "f0": np.ascontiguousarray(f10[200:296, 240:304]),  # 96 x 64: 24 rows a rank
        "f1": np.ascontiguousarray(f11[200:296, 240:304]),
        "lr": np.ascontiguousarray(lenna[::2, ::2][64:128, 40:88]),  # 64 x 48: 16 rows a rank
        "batch": np.ascontiguousarray(batch),  # 8 x 32 x 48
        "y01": (lenna[:64, :64].astype(np.float32) / 255.0),
    }


def poisoned(x, n: int, i: int, seed: int):
    """``x`` with every block of dim 0 but the i-th of n replaced by noise."""
    x = np.array(x, copy=True)
    rng = np.random.default_rng(seed)
    b = x.shape[0] // n
    keep = x[i * b : (i + 1) * b].copy()
    if x.dtype == np.uint8:
        x[:] = rng.integers(0, 256, x.shape, dtype=np.uint8)
    elif np.issubdtype(x.dtype, np.integer):
        x[:] = rng.integers(0, int(x.max()) + 1, x.shape).astype(x.dtype)
    else:
        x[:] = rng.standard_normal(x.shape).astype(x.dtype)
    x[i * b : (i + 1) * b] = keep
    return x


def main(device, out_path: str) -> None:
    rank = dist.get_rank()
    if dist.get_world_size() != RANKS:
        raise RuntimeError(f"run on {RANKS} ranks, not {dist.get_world_size()}")
    x = inputs()
    mesh = parallel.make_mesh(device=device)
    mesh22 = parallel.make_mesh((2, 2), ("dp", "tp"), device=device)
    model = RaisrModel.load(asset_path("raisr_filters_x2.npz"), device=device)
    res = {}

    def both(name, fn, *arrays, n=RANKS, i=mesh.coords["data"]):
        res[name] = fn(*arrays)
        res["poisoned_" + name] = fn(*(poisoned(a, n, i, 100 + rank) for a in arrays))

    both("histeq_global", lambda g: parallel.histeq_global_sharded(g, mesh), x["gray"])
    for clahe in (0.0, 2.0):
        both(f"histeq_local_{clahe:g}", lambda g: parallel.histeq_local_sharded(
            g, mesh, blockshape=BLOCK, clahe_clip=clahe), x["local"])
    both("motion_fast", lambda a, b: parallel.motion_fast_sharded(a, b, mesh), x["f0"], x["f1"])
    both("motion_exact", lambda a, b: parallel.motion_exact_sharded(a, b, mesh),
         x["f0"], x["f1"])
    res["motion_exact_9_3"] = parallel.motion_exact_sharded(
        x["f0"], x["f1"], mesh, search_size=9, patch_size=3)
    both("raisr", lambda lr: parallel.raisr_upsample_sharded(lr, model.filters, model.cfg, mesh),
         x["lr"])
    both("data_parallel", parallel.data_parallel(ops.histeq_global, mesh), x["batch"])
    sharded = EnhancePipeline(PIPE, raisr_model=model).sharded(mesh)
    for tag, batch in (("", x["batch"][:RANKS]),
                       ("poisoned_", poisoned(x["batch"][:RANKS], RANKS, mesh.coords["data"],
                                              100 + rank))):
        out, levels = sharded(batch)
        res[tag + "pipeline"] = out
        res.update({f"{tag}pipeline_level{k}": lv for k, lv in enumerate(levels)})

    cfg = RaisrConfig()
    p, t, f = _training_arrays(torch.from_numpy(x["y01"]), cfg)
    x.update(patches=p.numpy(), targets=t.numpy(), fidx=f.numpy())
    both("train", lambda a, b, c: parallel.raisr_train_step(
        a, b, c, cfg.num_filters, cfg.filter_len, mesh22, chunk=256),
        x["patches"], x["targets"], x["fidx"], n=2, i=mesh22.coords["dp"])
    res.update({"dry_" + k: v for k, v in dryrun_rank(device).items()})
    if rank == 0:
        arrays = {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v
                  for k, v in {**x, **res}.items()}
        np.savez(out_path, **arrays)
