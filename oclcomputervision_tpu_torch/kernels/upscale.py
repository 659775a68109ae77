"""Cheap bilinear upscale straight into parity planes.

Port of ``oclcomputervision_tpu/ops/pallas/upscale_pallas.py``
(``upscale_planes_pallas``). ``upscale_planes`` is the plain PyTorch version,
mirroring the XLA twin ``ops/raisr.upscale_planes``;
``upscale_planes_kernel`` is the wrapper over ``csrc/upscale_planes.cu``.

Both compute, per plane element, the same separately rounded f32 products
and sums in the same sorted-offset order, so the kernel matches the plain
version bit for bit. Against the JAX twin the bound is 1 f32 ULP (XLA:CPU
contracts multiply-adds into FMAs).

Geometry: ``[B, h, w]`` f32 -> ``[B, s*s, hq, wq]`` f32 planes, origin
(hp, hp), edge-replicated outside the image. Unlike the TPU kernel there
are no zero tail rows past hq (a tile artefact no consumer reads).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from oclcomputervision_tpu_torch.kernels._build import launch, require_cuda_tensor


def _axis_taps(n_in: int, s: int, org: int, n_out: int):
    """Per phase, the sorted (offset, weight vector) pairs of one axis."""
    from oclcomputervision_tpu_torch.ops.raisr import _phase_stencil_taps

    return [
        sorted(_phase_stencil_taps(n_in, s, a, org, n_out)[2].items())
        for a in range(s)
    ]


def upscale_planes(x01: torch.Tensor, cfg, hq: int, wq: int, hp: int) -> torch.Tensor:
    """Plain version: [B, h, w] f32 -> [B, s*s, hq, wq] f32 parity planes."""
    s = cfg.scale
    bsz, h, w = x01.shape
    x = x01.to(torch.float32)
    dev = x.device
    row_taps = _axis_taps(h, s, hp, hq)
    col_taps = _axis_taps(w, s, hp, wq)
    rows = torch.arange(hq, device=dev)
    cols = torch.arange(wq, device=dev)
    planes = []
    for a in range(s):
        # vertical pass: per-row weights, source rows clamped to the image
        v = torch.zeros((bsz, hq, w), dtype=torch.float32, device=dev)
        for d, wv in row_taps[a]:
            src = torch.clamp(rows + d, 0, h - 1)
            v = v + torch.from_numpy(wv).to(dev)[:, None] * x[:, src, :]
        for b in range(s):
            # horizontal pass: per-column weights
            o = torch.zeros((bsz, hq, wq), dtype=torch.float32, device=dev)
            for d, wv in col_taps[b]:
                src = torch.clamp(cols + d, 0, w - 1)
                o = o + torch.from_numpy(wv).to(dev)[None, :] * v[:, :, src]
            planes.append(o)
    return torch.stack(planes, dim=1)


@functools.lru_cache(maxsize=16)
def _device_tables(h: int, w: int, s: int, hp: int, hq: int, wq: int, device):
    """Offsets [s, nd] i32, offset counts [s] i32 and weights [s, nd, n]
    f32 for rows and for columns, on the device; nd = most offsets of any
    phase on either axis."""
    axes = (_axis_taps(h, s, hp, hq), _axis_taps(w, s, hp, wq))
    nd = max(len(ph) for taps in axes for ph in taps)
    out = []
    for taps, n_out in zip(axes, (hq, wq)):
        off = np.zeros((s, nd), np.int32)
        cnt = np.array([len(ph) for ph in taps], np.int32)
        wgt = np.zeros((s, nd, n_out), np.float32)
        for a, ph in enumerate(taps):
            for k, (d, wv) in enumerate(ph):
                off[a, k] = d
                wgt[a, k] = wv
        out += [torch.from_numpy(t).to(device) for t in (off, cnt, wgt)]
    return tuple(out), nd


def upscale_planes_kernel(
    x01: torch.Tensor, cfg, hq: int, wq: int, hp: int
) -> torch.Tensor:
    """Wrapper: the plain version for a CPU tensor, the CUDA kernel for a
    CUDA tensor (contiguous [B, h, w] f32)."""
    if x01.device.type == "cpu":
        return upscale_planes(x01, cfg, hq, wq, hp)
    require_cuda_tensor(x01, "x01", torch.float32, 3)
    s = cfg.scale
    nimg, h, w = x01.shape
    if hq > 8 * 65535 or nimg * s * s > 65535:
        raise ValueError(f"grid too large: hq={hq}, images*planes={nimg * s * s}")
    tabs, nd = _device_tables(h, w, s, hp, hq, wq, x01.device)
    out = torch.empty((nimg, s * s, hq, wq), dtype=torch.float32, device=x01.device)
    launch(
        "upscale_planes", "ocvk_upscale_planes", x01.device,
        x01.data_ptr(), out.data_ptr(), *(t.data_ptr() for t in tabs),
        nimg, h, w, s, hq, wq, nd,
    )
    return out
