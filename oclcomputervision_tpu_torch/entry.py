"""Entry points: the flagship RAISR x2 inference step, on the card by
default, and the multi-process dry run.

``entry`` is the counterpart of ``__graft_entry__.entry()``: the same 64x64
uint8 image and the same seeded filter bank (identity plus 0.01 noise), on
``device`` (None: the card; ``"cpu"`` runs the plain versions).
``dryrun_multichip`` is the counterpart of ``__graft_entry__.dryrun_multichip``
on an n-rank ``torch.distributed`` group.
"""

from __future__ import annotations

import numpy as np
import torch

from oclcomputervision_tpu_torch._device import as_device
from oclcomputervision_tpu_torch.ops.raisr import raisr_upsample
from oclcomputervision_tpu_torch.utils.config import RaisrConfig


def entry(device=None):
    """Returns (fn, (image, filter_bank)); ``fn(*args)`` upsamples x2."""
    dev = as_device(device)
    cfg = RaisrConfig(fidelity="full")
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, size=(64, 64), dtype=np.uint8)
    filters = rng.standard_normal(
        (cfg.num_filters, cfg.filter_len, cfg.filter_len)
    ).astype(np.float32) * 0.01
    filters[:, cfg.filter_len // 2, cfg.filter_len // 2] += 1.0

    def fn(image_u8, filter_bank):
        return raisr_upsample(image_u8, filter_bank, cfg)

    return fn, (torch.from_numpy(img).to(dev), torch.from_numpy(filters).to(dev))


def dryrun_rank(device) -> dict:
    """One rank's dry run, on an initialised process group of n ranks: one
    distributed RAISR training step on a (dp, tp) mesh (tp = 2 when n is
    even), then on a row mesh of n the global and the local-block histeq and
    the RAISR upsample, on tiny shapes made from seed 0. Raises if an output
    has the wrong shape; returns the inputs and outputs by name."""
    import torch.distributed as dist

    from oclcomputervision_tpu_torch import parallel
    from oclcomputervision_tpu_torch.models.raisr import _training_arrays

    n = dist.get_world_size()
    tp = 2 if n % 2 == 0 else 1
    dp = n // tp
    mesh = parallel.make_mesh((dp, tp), ("dp", "tp"), device=device)
    cfg = RaisrConfig()
    rng = np.random.default_rng(0)
    hr = rng.random((8 * dp, 32), dtype=np.float32)
    p, t, f = _training_arrays(torch.from_numpy(hr).to(mesh.device), cfg)
    rows = p.shape[0] - p.shape[0] % dp
    out = {"hr": hr}
    out["filters"] = parallel.raisr_train_step(
        p[:rows], t[:rows], f[:rows], cfg.num_filters, cfg.filter_len, mesh, chunk=64
    )
    sp = parallel.make_mesh((n,), ("data",), device=device)
    out["gray"] = rng.integers(0, 256, size=(16 * n, 64), dtype=np.uint8)
    out["histeq_global"] = parallel.histeq_global_sharded(out["gray"], sp)
    out["gray_local"] = rng.integers(0, 256, size=(32 * n, 64), dtype=np.uint8)
    out["histeq_local"] = parallel.histeq_local_sharded(out["gray_local"], sp, blockshape=(32, 32))
    out["lr"] = rng.integers(0, 256, size=(16 * n, 64), dtype=np.uint8)
    out["raisr"] = parallel.raisr_upsample_sharded(
        out["lr"], out["filters"], RaisrConfig(fidelity="full"), sp, halo=8
    )
    want = {
        "filters": (cfg.num_filters, cfg.filter_len, cfg.filter_len),
        "histeq_global": out["gray"].shape,
        "histeq_local": out["gray_local"].shape,
        "raisr": (out["lr"].shape[0] * cfg.scale, out["lr"].shape[1] * cfg.scale),
    }
    for name, shape in want.items():
        if tuple(out[name].shape) != tuple(shape):
            raise AssertionError(f"dry run: {name} is {tuple(out[name].shape)}, not {shape}")
    return out


def dryrun_multichip(n_devices: int, device=None, timeout: float | None = None) -> None:
    """Run ``dryrun_rank`` on ``n_devices`` gloo ranks started by
    ``parallel/launch.py`` in a child process (``parallel.launch.spawn``, so
    the caller's process is never re-imported by the ranks), on the card
    (``device`` None; any number of ranks: gloo's payloads are staged
    through host memory) or, with ``device="cpu"``, on the CPU. Raises
    RuntimeError if a rank fails, and if there is no card unless the CPU
    was asked for."""
    from oclcomputervision_tpu_torch.parallel.launch import spawn

    dev = as_device(device)
    spawn(n_devices, "oclcomputervision_tpu_torch.entry:dryrun_rank", backend="gloo",
          device=dev.type, timeout=timeout)
