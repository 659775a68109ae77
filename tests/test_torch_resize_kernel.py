"""The resize kernel (``kernels/csrc/resize_sep.cu``) on the CPU: its
per-element order against the plain passes, its tile plan, its
registration and its wrapper's refusals. The kernel itself runs only on the
card (chip_smoke.py phase 7 holds it to the passes there, bit for bit)."""

import numpy as np
import pytest
import torch

from oclcomputervision_tpu_torch.kernels import _build
from oclcomputervision_tpu_torch.kernels import resize as kresize
from oclcomputervision_tpu_torch.ops import interpolation as interp

torch.set_num_threads(2)

SIZES = {"up": ((13, 17), (29, 38)), "down": ((31, 37), (12, 15))}


def _kernel_order(x4, rows, cols):
    """The kernel's arithmetic in torch f32: for each column tap j in order,
    r_j = 0 + sum_k yw[k] * x[yidx[k], xidx[j]], then o = 0 + sum_j xw[j] * r_j."""
    (yi, yw), (xi, xw) = rows, cols
    o = torch.zeros((x4.shape[0], yi.shape[1], xi.shape[1], x4.shape[3]))
    for j in range(xi.shape[0]):
        r = torch.zeros_like(o)
        for k in range(yi.shape[0]):
            r = r + yw[k][None, :, None, None] * x4[:, yi[k]][:, :, xi[j]]
        o = o + xw[j][None, None, :, None] * r
    return o


def _bits(t):
    return t.contiguous().view(torch.int32)


def _band_rows(h_img, s, row0, h):
    """A band's row table as ``ops.raisr._raisr_shipped`` builds it."""
    yidx, yw = interp._axis_table(h_img * s, h_img, "bilinear", "align_corners", torch.device("cpu"))
    q = torch.clamp(s * row0 + torch.arange(h * s), 0, h_img * s - 1)
    return torch.clamp(yidx[:, q] - row0, 0, h - 1), yw[:, q]


@pytest.mark.parametrize("nch", [1, 3])
@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("mapping", ["align_corners", "hw_sampler", "half_pixel"])
@pytest.mark.parametrize("method", ["bilinear", "bicubic"])
def test_kernel_order_equals_passes(method, mapping, size, nch):
    (h, w), out_hw = SIZES[size]
    rng = np.random.default_rng(len(method) + nch)
    x4 = torch.from_numpy(rng.integers(0, 256, (2, h, w, nch)).astype(np.float32))
    rows, cols = interp._tables(x4, out_hw, method, mapping, None)
    want = interp._resize_passes(x4, out_hw, method, mapping)
    assert torch.equal(_bits(_kernel_order(x4, rows, cols)), _bits(want))
    # a CPU tensor through _resize_plane is the passes themselves
    assert torch.equal(_bits(interp._resize_plane(x4, out_hw, method, mapping)), _bits(want))


def test_kernel_order_equals_passes_on_band_rows():
    x01 = torch.from_numpy(np.random.default_rng(3).random((1, 12, 21, 1), dtype=np.float32))
    rows = _band_rows(40, 2, -3, 12)
    _, cols = interp._tables(x01, (24, 42), "bilinear", "align_corners", rows)
    want = interp._resize_passes(x01, (24, 42), "bilinear", rows=rows)
    assert torch.equal(_bits(_kernel_order(x01, rows, cols)), _bits(want))


def _windows(idx, tile, nch=1, unit=1):
    """Per tile of ``tile`` consecutive outputs (of flattened elements when
    nch > 1), the window the kernel stages: rows (nch 1, unit 1) or the
    elements of a row from the start aligned down to ``unit``, rounded up."""
    idx = idx.numpy()
    n_el = idx.shape[1] * nch
    out = []
    for e0 in range(0, n_el, tile):
        px = slice(e0 // nch, (min(e0 + tile, n_el) - 1) // nch + 1)
        lo, hi = idx[:, px].min(), idx[:, px].max()
        s0 = lo * nch - (lo * nch) % unit
        out.append(-(-((hi + 1) * nch - s0) // unit) * unit)
    return max(out)


@pytest.mark.parametrize("case", [
    # (h_in, w_in, h_out, w_out, nch, method, in_bytes)
    (1440, 2560, 1080, 1920, 1, "bicubic", 1),  # the enhance cell's resize
    (1024, 1024, 2048, 2048, 1, "bicubic", 1),  # chip_smoke's RESIZE_BENCH
    (512, 512, 1024, 1024, 4, "bilinear", 4),  # fidelity='shipped', BGRA, f32
    (600, 900, 170, 260, 3, "bicubic", 1),  # a downscale by 3.5
])
def test_tile_plan_holds_every_window(case):
    h_in, w_in, h_out, w_out, nch, method, in_bytes = case
    taps = 4 if method == "bicubic" else 2
    tile_h, tile_w, span_h, pitch = kresize.tile_plan(h_in, w_in, h_out, w_out, nch, taps, in_bytes)
    assert span_h > 0 and tile_h <= 32 and tile_w >= 32
    assert span_h * pitch * in_bytes + tile_h * pitch * 4 <= kresize.SMEM_BUDGET
    assert (pitch * in_bytes) % 16 == 0
    dev = torch.device("cpu")
    for mapping in ("align_corners", "hw_sampler", "half_pixel"):
        yidx, _ = interp._axis_table(h_out, h_in, method, mapping, dev)
        xidx, _ = interp._axis_table(w_out, w_in, method, mapping, dev)
        # every block stages its window: none falls back to the direct form
        assert _windows(yidx, tile_h) <= span_h
        assert _windows(xidx, tile_w, nch, 16 // in_bytes) <= pitch


def test_tile_plan_band_rows_and_strong_downscale():
    # fidelity='shipped' on a band of 12 LR rows of a 40-row image, x2
    rows, _ = _band_rows(40, 2, -3, 12)
    tile_h, _, span_h, _ = kresize.tile_plan(12, 21, 24, 42, 1, 2, 4)
    assert 0 < _windows(rows, tile_h) <= span_h
    # a downscale by the tap count or more runs the direct form everywhere
    assert kresize.tile_plan(1024, 1024, 100, 1000, 1, 4, 1)[2] == 0
    assert kresize.tile_plan(1024, 1024, 1000, 10, 3, 2, 4)[2] == 0
    # a row wider than any tile's window: smaller tiles, else the direct form
    tile_h, tile_w, span_h, pitch = kresize.tile_plan(8, 40000, 16, 20000, 4, 4, 4)
    assert span_h == 0 or span_h * pitch * 4 + tile_h * pitch * 4 <= kresize.SMEM_BUDGET


def test_kernel_is_registered():
    assert _build.LAUNCHES["resize_sep"] == 0
    assert "ocvk_resize_sep" in _build._SIGNATURES
    assert any(p.endswith("resize_sep.cu") for p in _build._sources())


def test_wrapper_refuses():
    rows = cols = interp._axis_table(8, 4, "bicubic", "align_corners", torch.device("cpu"))
    x = torch.zeros((1, 4, 4, 1), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kresize.resize_sep(x, rows, cols)
    with pytest.raises(ValueError, match="uint8 or float32"):
        kresize.resize_sep(x.to(torch.int16), rows, cols)
    with pytest.raises(ValueError, match="contiguous"):
        kresize.resize_sep(torch.zeros((1, 4, 4, 2), dtype=torch.uint8)[..., :1], rows, cols)
    assert _build.LAUNCHES["resize_sep"] == 0
