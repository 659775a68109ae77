"""PyTorch port: the RAISR tables, the PNG reader, the device rules and the
import of the port with JAX and the JAX package blocked, all on the CPU."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from oclcomputervision_tpu.ops import raisr as jax_raisr
from oclcomputervision_tpu.ops.pallas import raisr_pallas
from oclcomputervision_tpu.utils import load_gray, load_image
from oclcomputervision_tpu.utils.config import RaisrConfig
from oclcomputervision_tpu_torch.kernels import _build
from oclcomputervision_tpu_torch.kernels import raisr as kraisr
from oclcomputervision_tpu_torch.kernels import upscale as kupscale
from oclcomputervision_tpu_torch.ops import raisr as port
from oclcomputervision_tpu_torch.utils import png

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALES = [2, 3, 4]
PNGS = ["lenna.png", "frame10.png", "frame11.png"]


@pytest.mark.parametrize("s", SCALES)
def test_phase_stencil_taps_equal_jax(s):
    for n_in, org, n_out in [(100, 3, 136), (64, 3, 200), (50, 2, 72), (1024, 3, 1032)]:
        for phase in range(s):
            want = jax_raisr._phase_stencil_taps(n_in, s, phase, org, n_out)
            got = port._phase_stencil_taps(n_in, s, phase, org, n_out)
            assert got[:2] == want[:2]
            assert sorted(got[2]) == sorted(want[2])
            for d, wv in want[2].items():
                assert got[2][d].dtype == wv.dtype
                np.testing.assert_array_equal(got[2][d], wv)


@pytest.mark.parametrize("s", SCALES)
def test_blur_k1_equal_jax(s):
    for glen, sigma in [(9, 2.0), (7, 1.5)]:
        cfg = RaisrConfig(scale=s, gauss_len=glen, gauss_sigma=sigma)
        np.testing.assert_array_equal(port._blur_k1(cfg), jax_raisr._blur_k1(cfg))


@pytest.mark.parametrize("s", SCALES)
def test_plane_halo_and_geometry_equal_jax(s):
    cfg = RaisrConfig(scale=s)
    for fl, glen in [(11, 9), (7, 5), (11, 7)]:
        assert port.plane_halo(fl, s, glen) == raisr_pallas.plane_halo(fl, s, glen)
    # ops/raisr.py:_raisr_planes_batched's geometry rule
    for h, w in [(64, 100), (100, 130), (1024, 1024), (240, 320)]:
        geo = port.plane_geometry(h, w, cfg)
        h2p = -(-h // raisr_pallas.TILE_H) * raisr_pallas.TILE_H
        w2p = -(-w // 128) * 128
        hp = raisr_pallas.plane_halo(cfg.filter_len, s, cfg.gauss_len)
        assert (geo.h2p, geo.w2p, geo.hp) == (h2p, w2p, hp)
        assert (geo.hq, geo.wq) == (h2p + raisr_pallas.HALO_ROWS, w2p + 128)


@pytest.mark.parametrize("s", SCALES)
def test_tap_tables_equal_jax(s):
    hp = raisr_pallas.plane_halo(11, s, 9)
    for py in range(s):
        for px in range(s):
            assert port._tap_tables(11, s, py, px, hp) == raisr_pallas._tap_tables(
                11, s, py, px, hp
            )


@pytest.mark.parametrize("name", PNGS)
def test_png_rgb_equals_load_image(name):
    got = png.load_image(name)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, load_image(name))


@pytest.mark.parametrize("name", PNGS)
def test_png_gray_within_one_level_of_load_gray(name):
    import cv2

    got = png.load_gray(name).astype(int)
    rgb = load_image(name)
    # cv2's fixed-point BT.601 on the same RGB
    want = cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY).astype(int)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1
    if name != "lenna.png":
        # load_gray itself; lenna.png carries an sRGB chunk, for which
        # libpng (under cv2.imread's grayscale mode) converts in linear light
        assert np.abs(got - load_gray(name).astype(int)).max() <= 1


def test_png_rejects_other_formats(tmp_path):
    bad = tmp_path / "x.png"
    bad.write_bytes(b"not a png")
    with pytest.raises(ValueError):
        png.read_png(str(bad))


def test_wrappers_take_the_plain_path_for_cpu_tensors():
    cfg = RaisrConfig()
    geo = port.plane_geometry(20, 30, cfg)
    rng = np.random.default_rng(0)
    x01 = torch.from_numpy(rng.random((1, 20, 30), dtype=np.float32))
    filters = torch.from_numpy(
        rng.standard_normal((cfg.num_filters, 11, 11)).astype(np.float32)
    )
    _build.reset_launches()
    up = kupscale.upscale_planes_kernel(x01, cfg, geo.hq, geo.wq, geo.hp)
    assert torch.equal(up, kupscale.upscale_planes(x01, cfg, geo.hq, geo.wq, geo.hp))
    hb = kraisr.hash_planes_kernel(up, cfg, geo.hp, geo.h2p, geo.w2p)
    assert torch.equal(hb, kraisr.hash_planes(up, cfg, geo.hp, geo.h2p, geo.w2p))
    ap = kraisr.apply_filters_planes_kernel(up, hb, filters, cfg)
    assert torch.equal(ap, kraisr.apply_filters_planes(up, hb, filters, cfg))
    assert set(_build.LAUNCHES.values()) == {0}  # no kernel ran


def test_wrappers_reject_tensors_on_other_devices():
    cfg = RaisrConfig()
    x = torch.empty((1, 8, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        kupscale.upscale_planes_kernel(x, cfg, 72, 256, 3)
    planes = torch.empty((1, 4, 72, 256), device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        kraisr.hash_planes_kernel(planes, cfg, 3, 64, 128)
    buckets = torch.empty((1, 4, 64, 128), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        kraisr.apply_filters_planes_kernel(planes, buckets, planes, cfg)


def test_kernel_build_inputs():
    names = sorted(os.path.basename(p) for p in _build._sources())
    assert names == [
        "apply_lut.cu", "blend_blocks.cu", "errors.cu", "flow_median.cu", "hist256.cu",
        "hist_common.cuh", "hist_tiles.cu", "me_exact.cu", "me_fast_median.cu",
        "me_fast_round.cu", "raisr_apply.cu", "raisr_apply_generic.cu", "raisr_apply_split.cu",
        "raisr_apply_tile.cuh", "raisr_hash.cu", "raisr_hash_generic.cu", "resize_sep.cu",
        "subpixel_fit.cu", "upscale_planes.cu",
    ]
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    # every wrapper's C entry point has declared argument types
    assert set(_build._SIGNATURES) == {
        "ocvk_upscale_planes", "ocvk_raisr_hash", "ocvk_raisr_apply",
        "ocvk_raisr_hash_generic", "ocvk_raisr_apply_generic", "ocvk_raisr_apply_split",
        "ocvk_hist256", "ocvk_apply_lut", "ocvk_hist_tiles", "ocvk_blend_blocks",
        "ocvk_me_exact", "ocvk_me_fast_round", "ocvk_me_fast_median", "ocvk_resize_sep",
        "ocvk_flow_median", "ocvk_flow_median_generic", "ocvk_subpixel_fit",
    }
    assert set(_build.LAUNCHES) == {
        "upscale_planes", "raisr_hash", "raisr_apply",
        "upscale_planes_generic", "raisr_hash_generic", "raisr_apply_generic",
        "raisr_apply_split", "hist256", "apply_lut", "hist_tiles", "blend_blocks",
        "me_exact", "me_fast_round", "me_fast_median", "resize_sep",
        "flow_median", "flow_median_generic", "subpixel_fit",
    }


_NO_JAX = r"""
import importlib, importlib.abc, pkgutil, sys

class BlockJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "oclcomputervision_tpu"):
            raise ImportError("blocked: " + name)

sys.meta_path.insert(0, BlockJax())
import numpy as np
import torch
import oclcomputervision_tpu_torch as pkg

for mod in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(mod.name)
from oclcomputervision_tpu_torch.ops import histeq_global, histeq_local_block
from oclcomputervision_tpu_torch.ops.raisr import raisr_upsample
from oclcomputervision_tpu_torch.utils.config import RaisrConfig

img = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (24, 40), dtype=np.uint8))
out = raisr_upsample(img, None, RaisrConfig())
assert out.shape == (48, 80) and out.dtype == torch.uint8
assert histeq_global(img).shape == (24, 40)
assert histeq_local_block(img, blockshape=(12, 20)).shape == (24, 40)
assert not any(
    m.split(".")[0] in ("jax", "jaxlib", "oclcomputervision_tpu") for m in sys.modules
)
print("NO_JAX_OK")
"""


def test_port_imports_and_runs_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-c", _NO_JAX], capture_output=True, text=True,
        cwd=REPO, env=env, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert "NO_JAX_OK" in res.stdout
