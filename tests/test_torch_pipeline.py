"""PyTorch port: ``EnhancePipeline`` and the compat API on the CPU, against
the JAX package's (XLA twins on the CPU). Equalization is held equal, resize,
pyramid and local equalization within one level, histograms and motion bit
for bit, and RAISR above 40 dB PSNR against the JAX package's XLA twin
(the ROADMAP's RAISR contract: the port's apply takes bf16 taps and bank as
the TPU kernel does, the XLA twin f32 ones)."""

import re

import jax
import numpy as np
import pytest
import torch

from oclcomputervision_tpu import compat as jax_compat
from oclcomputervision_tpu.models.pipeline import EnhanceConfig as JaxEnhanceConfig
from oclcomputervision_tpu.models.pipeline import EnhancePipeline as JaxEnhancePipeline
from oclcomputervision_tpu.models.raisr import RaisrModel as JaxRaisrModel
from oclcomputervision_tpu.utils import psnr
from oclcomputervision_tpu_torch import compat
from oclcomputervision_tpu_torch.models import EnhanceConfig, EnhancePipeline, RaisrModel
from oclcomputervision_tpu_torch.utils import asset_path

torch.set_num_threads(2)

WITHIN_ONE = 0.999  # RAISR 'shipped': share of values within one level
RAISR_PSNR = 40.0  # dB, RAISR 'full' against the XLA twin (PARITY.md C10)


@pytest.fixture(scope="module", autouse=True)
def _drop_jax_programs():
    yield
    jax.clear_caches()


def _maxdiff(a, b) -> int:
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    return int(np.abs(a.astype(int) - b.astype(int)).max())


def _within_one(a, b) -> float:
    return float((np.abs(np.asarray(a, int) - np.asarray(b, int)) <= 1).mean())


@pytest.fixture(scope="module")
def ue(under_exposure_gray):
    return np.ascontiguousarray(under_exposure_gray[:256, :512])


# ---------------------------------------------------------------------------
# EnhancePipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batch"])
@pytest.mark.parametrize("equalize", ["global", "local", "none"])
def test_pipeline_matches_jax(equalize, batched, ue):
    x = np.stack([ue, ue[::-1].copy()]) if batched else ue
    # the equalized stage alone: equal
    eq_only = dict(equalize=equalize)
    got = EnhancePipeline(EnhanceConfig(**eq_only))(x, device="cpu")
    want = JaxEnhancePipeline(JaxEnhanceConfig(**eq_only))(x)
    assert _maxdiff(got.numpy(), want) == 0
    # then resize and pyramid: within one level
    kw = dict(equalize=equalize, resize_to=(128, 256), pyramid_depth=2)
    out, pyr = EnhancePipeline(EnhanceConfig(**kw))(torch.from_numpy(x))
    jout, jpyr = JaxEnhancePipeline(JaxEnhanceConfig(**kw))(x)
    lead = (2,) if batched else ()
    assert tuple(out.shape) == lead + (128, 256)
    assert [tuple(p.shape) for p in pyr] == [lead + (64, 128), lead + (128, 256)]
    assert _maxdiff(out.numpy(), jout) <= 1
    for p, jp in zip(pyr, jpyr):
        assert _maxdiff(p.numpy(), jp) <= 1


@pytest.fixture(scope="module")
def x2_banks():
    path = asset_path("raisr_filters_x2.npz")
    return RaisrModel.load(path, device="cpu"), JaxRaisrModel.load(path)


def test_pipeline_raisr_matches_jax(ue, x2_banks):
    model, jmodel = x2_banks
    g = ue[:64, :128]
    batch = np.stack([g, g[::-1].copy()])
    kw = dict(superres="raisr", resize_to=(96, 200), resize_method="bilinear")
    got = EnhancePipeline(EnhanceConfig(**kw), raisr_model=model)(batch, device="cpu")
    want = np.asarray(JaxEnhancePipeline(JaxEnhanceConfig(**kw), raisr_model=jmodel)(batch))
    assert tuple(got.shape) == want.shape == (2, 96, 200)
    assert psnr(got.numpy(), want) > RAISR_PSNR
    # without the resize: the RAISR stage after the default global equalization
    kw = dict(superres="raisr")
    single = EnhancePipeline(EnhanceConfig(**kw), raisr_model=model)(batch[0], device="cpu")
    jsingle = np.asarray(JaxEnhancePipeline(JaxEnhanceConfig(**kw), raisr_model=jmodel)(batch[0]))
    assert tuple(single.shape) == jsingle.shape == (128, 256)
    assert psnr(single.numpy(), jsingle) > RAISR_PSNR


def test_pipeline_errors_and_device(ue):
    with pytest.raises(ValueError, match="RaisrModel"):
        EnhancePipeline(EnhanceConfig(superres="raisr"))
    with pytest.raises(ValueError, match="RaisrModel"):
        EnhancePipeline(EnhanceConfig(superres="raisr"), raisr_model=RaisrModel())
    with pytest.raises(ValueError, match="superres"):
        EnhancePipeline(EnhanceConfig(superres="bogus"))
    # a numpy input runs on the card unless the CPU is asked for
    with pytest.raises(RuntimeError, match="cuda"):
        EnhancePipeline()(ue[:32, :32])


# ---------------------------------------------------------------------------
# compat
# ---------------------------------------------------------------------------


def test_compat_histeq_matches_jax(ue, capsys):
    g = ue[:128, :256]
    got = compat.histeq_global(g, 1, 0.05, 2, device="cpu")
    out = capsys.readouterr().out
    assert re.search(
        r"global histogram equalization took GPU: \d+\.\d{3} \+ \d+\.\d{3} ms, CPU: \d+\.\d{3} ms",
        out,
    ), out
    assert _maxdiff(got, jax_compat.histeq_global(g, 1, 0.05, 2)) == 0
    assert _maxdiff(compat.histeq_global(g, use_gpu=False), jax_compat.histeq_global(g, use_gpu=False)) == 0
    got = compat.histeq_local_block(g, blockshape=(64, 128), device="cpu")
    assert "local histogram equalization (block-based) took GPU:" in capsys.readouterr().out
    assert _maxdiff(got, jax_compat.histeq_local_block(g, blockshape=(64, 128))) <= 1
    hist = np.bincount(g.reshape(-1), minlength=256)
    np.testing.assert_array_equal(
        compat.calc_transfer_func(hist, 1, 0.05, 2), jax_compat.calc_transfer_func(hist, 1, 0.05, 2)
    )
    # the card is the default; without one it raises, never the oracle
    with pytest.raises(RuntimeError, match="cuda"):
        compat.histeq_global(g)
    with pytest.raises(RuntimeError, match="cuda"):
        compat.histeq_local_block(g)


def test_compat_cpu_local_histeq_mutates_input_in_place(ue):
    g = ue[:128, :256].copy()
    before = g.copy()
    out = compat.histeq_local_block(g, blockshape=(64, 128), use_gpu=False)
    assert out is g and not np.array_equal(g, before)
    want = jax_compat.histeq_local_block(before.copy(), blockshape=(64, 128), use_gpu=False)
    np.testing.assert_array_equal(out, want)
    # a read-only input is left alone and a new array returned
    ro = before.copy()
    ro.flags.writeable = False
    out = compat.histeq_local_block(ro, blockshape=(64, 128), use_gpu=False)
    assert out is not ro and np.array_equal(ro, before)
    np.testing.assert_array_equal(out, want)


def test_compat_histeq_runtime_matches_jax(ue):
    eq = compat.HistEq(device="cpu")
    jeq = jax_compat.HistEq.getInstance()
    assert compat.clHistEq.getInstance() is compat.HistEq.getInstance()
    assert compat.HistEq.getInstance().device is None  # the card
    g = ue[:256, :512]
    grid, ms = eq.histGrid(g)
    assert grid.dtype == np.uint32 and isinstance(ms, float)
    np.testing.assert_array_equal(grid, jeq.histGrid(g)[0])
    lut = np.random.default_rng(1).integers(0, 256, 256).astype(np.uint8)
    np.testing.assert_array_equal(eq.histeqGlobal(g, lut)[0], jeq.histeqGlobal(g, lut)[0])
    maps = np.random.default_rng(2).uniform(0, 255, (2, 3, 256)).astype(np.float32)
    got = eq.histeqLocalBlock(g[:200, :300], maps, (128, 128))[0]
    assert _maxdiff(got, jeq.histeqLocalBlock(g[:200, :300], maps, (128, 128))[0]) <= 1


@pytest.mark.parametrize("method", ["bilinear", "bilinear_lds", "bicubic", "bicubic_lds"])
def test_compat_utility_matches_jax(method, lenna_rgb, lenna_gray):
    util, jutil = compat.clUtility(device="cpu"), jax_compat.clUtility()
    for src, shape in ((lenna_rgb[:32, :40], (64, 80, 3)), (lenna_gray[:48, :48], (24, 30))):
        dst, jdst = np.zeros(shape, np.uint8), np.zeros(shape, np.uint8)
        ms = getattr(util, method)(np.ascontiguousarray(src), dst)
        getattr(jutil, method)(src, jdst)
        assert isinstance(ms, list) and len(ms) == 1 and dst.any()
        assert _maxdiff(dst, jdst) <= 1


def test_compat_raisr_matches_jax(lenna_gray, capsys):
    r, jr = compat.ClRaisr(0, device="cpu"), jax_compat.ClRaisr(0)
    src = lenna_gray[:48, :64]
    dst, jdst = np.zeros((96, 128), np.uint8), np.zeros((96, 128), np.uint8)
    ms = r.upsample(src, dst, 2)
    jr.upsample(src, jdst, 2)
    assert len(ms) == 1 and dst.std() > 5
    assert psnr(dst, jdst) > RAISR_PSNR
    assert r.upsample(src, np.zeros((144, 192), np.uint8), 3) == []
    assert "Fatal. not trained for scale factor 3" in capsys.readouterr().out
    shipped = compat.Raisr(0, fidelity="shipped", device="cpu")
    jshipped = jax_compat.Raisr(0, fidelity="shipped")
    shipped.upsample(src, dst, 2)
    jshipped.upsample(src, jdst, 2)
    assert _within_one(dst, jdst) >= WITHIN_ONE


def test_compat_motion_matches_jax(frames_gray, tmp_path):
    from oclcomputervision_tpu_torch.oracle import motion as port_oracle_motion

    g0, g1 = (np.ascontiguousarray(f[100:140, 200:248]) for f in frames_gray)
    # the defaults against the numpy oracle (the JAX package's 15/5 program
    # compiles for seconds on the CPU), 9/3 against the JAX package
    mv = compat.estimate_motion_vector(g0, g1, searchSize=15, patchSize=5, pyrScale=2, device="cpu")
    assert mv.dtype == np.float32 and mv.shape == (40, 48, 2)
    np.testing.assert_array_equal(mv, port_oracle_motion.estimate_motion_vector(g0, g1, 15, 5))
    np.testing.assert_array_equal(
        compat.estimate_motion_vector(g0, g1, 9, 3, device="cpu"),
        jax_compat.estimate_motion_vector(g0, g1, 9, 3),
    )
    seed = np.random.default_rng(4).uniform(-5, 5, (40, 48, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        compat.estimate_motion_vector(g0, g1, 15, 5, seed=seed, device="cpu"),
        jax_compat.estimate_motion_vector(g0, g1, 15, 5, seed=seed),
    )
    flow = np.random.default_rng(5).uniform(0.5, 2, (8, 10, 2)).astype(np.float32)
    up = compat.upscale_mv(flow, 2, device="cpu")
    assert up.shape == (16, 20, 2)
    np.testing.assert_allclose(up, jax_compat.upscale_mv(flow, 2), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(compat.mv2hsv(mv, 2), jax_compat.mv2hsv(mv, 2))
    for got, want in zip(compat.gaussian_pyramid(g0, 2, 3, device="cpu"), jax_compat.gaussian_pyramid(g0, 2, 3)):
        assert _maxdiff(got, want) <= 1
    path = str(tmp_path / "f.flo")
    compat.write_flo(mv, path)
    np.testing.assert_array_equal(jax_compat.read_flo(path), mv)
    with pytest.raises(RuntimeError, match="cuda"):
        compat.estimate_motion_vector(g0, g1)


def test_compat_me_helpers_match_jax(frames_gray):
    rng = np.random.default_rng(3)
    p0, p1 = rng.integers(0, 256, (2, 5, 5)).astype(np.uint8)
    for name in ("SAD", "SSD", "WSAD"):
        assert getattr(compat, name)(p0, p1) == getattr(jax_compat, name)(p0, p1)
    np.testing.assert_array_equal(compat.gaussian2d((5, 5), 2.0), jax_compat.gaussian2d((5, 5), 2.0))
    g0, g1 = frames_gray
    h, w = g0.shape
    for r, c, size in ((0, 0, 5), (h - 1, w - 1, 5), (-2, 5, 5), (h + 3, w + 3, 5), (7, 9, 11)):
        args = (r - size // 2, r + size // 2 + 1, c - size // 2, c + size // 2 + 1, size)
        np.testing.assert_array_equal(
            compat.get_region_padded(g0, *args), jax_compat.get_region_padded(g0, *args)
        )
    patch = g0[50:55, 60:65]
    for step in (5, 2, 1):
        region = g1[43:62, 53:72]
        assert compat.get_displacement(patch, region, step) == jax_compat.get_displacement(
            patch, region, step
        )
    assert compat.get_displacement(patch, g1[:3, :3], 1) == (0, 0)


def test_compat_public_names_match_jax():
    public = {n for n in dir(jax_compat) if not n.startswith("_")}
    # the JAX module's imports of its own package are not API
    public -= {"np", "ops", "oracle", "timed", "RaisrConfig", "annotations", "Optional", "Tuple"}
    missing = sorted(n for n in public if not hasattr(compat, n))
    assert not missing, missing
    assert compat.clHistEq is compat.HistEq and compat.clUtility is compat.Utility
    assert compat.ClRaisr is compat.Raisr and compat.Utility.bicubic_lds is compat.Utility.bicubic
    assert compat.visualizeME is False and compat.visualizeSearch is False
