"""PyTorch port: ``oclcomputervision_tpu_torch.parallel`` on the CPU.

(a) The band functions in this process against the JAX package's:
``apply_block_mappings_band``, ``_fast_residual_band`` (top, middle and
bottom bands) and the upscale of a band at the image's coordinates.

(b) One 4-rank gloo group, started once for the module through
``parallel/launch.py`` in a child process (clear of pytest-xdist, the
conftest and JAX), runs every entry point, ``EnhancePipeline.sharded`` and
the dry run's rank body (tests/torch_parallel_ranks.py) and writes one .npz.
Its results must equal the port's single-device ops bit for bit (the train
step: to float32 tolerance, its shards add in another order), be unchanged
when every row outside a rank's shard is poisoned, and agree with the JAX
package's sharded functions on 4 of the conftest's 8 virtual devices at the
tolerances of tests/test_parallel.py (RAISR: above 40 dB PSNR, PARITY.md
C10: the port's apply takes bf16 taps as the TPU kernel does).
``entry.dryrun_multichip(4, device="cpu")`` runs meanwhile.
"""

import os
import sys
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oclcomputervision_tpu import parallel as jax_parallel
from oclcomputervision_tpu.models.pipeline import EnhanceConfig as JaxEnhanceConfig
from oclcomputervision_tpu.models.pipeline import EnhancePipeline as JaxEnhancePipeline
from oclcomputervision_tpu.models.raisr import RaisrModel as JaxRaisrModel
from oclcomputervision_tpu.ops import histeq as jax_histeq
from oclcomputervision_tpu.ops import motion as jax_motion
from oclcomputervision_tpu.ops import raisr as jax_raisr
from oclcomputervision_tpu.utils import psnr
from oclcomputervision_tpu.utils.config import RaisrConfig as JaxRaisrConfig
from oclcomputervision_tpu_torch import entry, ops, parallel
from oclcomputervision_tpu_torch.kernels import upscale as kupscale
from oclcomputervision_tpu_torch.models import EnhancePipeline, RaisrModel
from oclcomputervision_tpu_torch.models.raisr import accumulate_normal_eq, solve_filters
from oclcomputervision_tpu_torch.ops import histeq as port_histeq
from oclcomputervision_tpu_torch.ops import motion as port_motion
from oclcomputervision_tpu_torch.ops.raisr import plane_geometry, raisr_upsample
from oclcomputervision_tpu_torch.oracle.interpolation import axis_weights
from oclcomputervision_tpu_torch.parallel import launch
from oclcomputervision_tpu_torch.utils import asset_path
from oclcomputervision_tpu_torch.utils.config import RaisrConfig

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
import torch_parallel_ranks as ranks_body  # noqa: E402

RAISR_PSNR = 40.0  # dB, the port's bf16 apply against the XLA twin (PARITY.md C10)
TRAIN_TOL = dict(atol=5e-3, rtol=1e-2)  # tests/test_parallel.py:130-132
LOCAL_SHARE = 1e-4  # within one level on this share (tests/test_parallel.py:98-100)
RANKS_TIMEOUT_S = 240


@pytest.fixture(scope="module", autouse=True)
def _drop_jax_programs():
    yield
    jax.clear_caches()


def _in_thread(fn, *args, **kwargs):
    """Start ``fn`` in a thread; the returned call waits for it and gives
    its value, or raises its exception."""
    box = {}

    def body():
        try:
            box["value"] = fn(*args, **kwargs)
        except BaseException as e:  # re-raised by the caller of result()
            box["error"] = e

    thread = threading.Thread(target=body)
    thread.start()

    def result():
        thread.join()
        if "error" in box:
            raise box["error"]
        return box.get("value")

    return result


@pytest.fixture(scope="module", autouse=True)
def group_runs(tmp_path_factory):
    """Start the 4-rank scenario and the dry run before the first test; the
    tests that need them wait for them. Each is one child process
    (``parallel.launch.spawn``), killed whole if it outlives its time."""
    out = str(tmp_path_factory.mktemp("ranks") / "ranks.npz")
    scenario = _in_thread(
        launch.spawn, ranks_body.RANKS, os.path.join(REPO, "tests", "torch_parallel_ranks.py")
        + ":main", (out,), device="cpu", timeout=RANKS_TIMEOUT_S, capture=True)
    dry = _in_thread(entry.dryrun_multichip, 4, device="cpu", timeout=RANKS_TIMEOUT_S)
    state = {}

    def results():
        if "npz" not in state:
            scenario()
            state["npz"] = dict(np.load(out))
        return state["npz"]

    yield types.SimpleNamespace(results=results, dry=dry)
    try:
        scenario()
    finally:
        dry()


@pytest.fixture(scope="module")
def npz(group_runs):
    return group_runs.results()


@pytest.fixture(scope="module")
def mesh4():
    return jax_parallel.make_mesh((4,), ("data",), devices=jax.devices()[:4])


@pytest.fixture(scope="module")
def banks():
    path = asset_path("raisr_filters_x2.npz")
    return RaisrModel.load(path, device="cpu"), JaxRaisrModel.load(path)


def _within_one(got, want, share):
    d = np.abs(np.asarray(got).astype(int) - np.asarray(want).astype(int))
    assert d.max() <= 1 and (d > 0).mean() <= share, (d.max(), (d > 0).mean())


# ---------------------------------------------------------------------------
# (a) the band functions, in this process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ty0", [0, 3, 6], ids=["top", "middle", "bottom"])
def test_apply_block_mappings_band_matches_jax(rng, ty0):
    nty = 3
    bh, bw = 64, 64
    img = rng.integers(0, 256, (512, 256), dtype=np.uint8)
    m = np.asarray(jax_histeq.block_mappings(img, 0.5, 0.05, 3.0, (bh, bw)))  # 8 x 4 blocks
    padded = np.pad(img, ((bh // 2, 9 * bh - 512 - bh // 2), (0, 0)))
    band = np.ascontiguousarray(padded[ty0 * bh : (ty0 + nty) * bh])
    want = np.asarray(jax_histeq.apply_block_mappings_band(band, m, (bh, bw), ty0, 256))
    got = port_histeq.apply_block_mappings_band(band, m, (bh, bw), ty0, 256, device="cpu")
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    _within_one(got.numpy(), want, LOCAL_SHARE)


@pytest.mark.parametrize("where", ["top", "middle", "bottom"])
def test_fast_residual_band_matches_jax(frames_gray, where):
    h, w = 96, 64
    f0, f1 = (np.ascontiguousarray(f[200 : 200 + h, 240 : 240 + w]) for f in frames_gray)
    hh = port_motion.fast_halo_rows()
    assert hh == jax_motion.fast_halo_rows() == 17
    size = 24 + 2 * hh
    r0 = {"top": -hh, "middle": 36 - hh, "bottom": h - 24 - hh}[where]

    def band(f):
        out = np.zeros((size, w), np.uint8)
        lo, hi = max(0, -r0), min(size, h - r0)
        out[lo:hi] = f[r0 + lo : r0 + hi]
        return out

    b0, b1 = band(f0), band(f1)
    want = np.asarray(jax_motion._fast_residual_band(
        jnp.asarray(b0, jnp.int32), jnp.asarray(b1, jnp.int32), r0, h, w))
    got = port_motion._fast_residual_band(torch.from_numpy(b0), torch.from_numpy(b1), r0, h, w)
    assert tuple(got.shape) == (size, w, 2) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy()[hh:-hh], want[hh:-hh].astype(np.float32))
    # and those rows are the whole image's
    whole = ops.estimate_motion_vector(f0, f1, method="fast", device="cpu").numpy()
    np.testing.assert_array_equal(got.numpy()[hh:-hh], whole[r0 + hh : r0 + size - hh])


@pytest.mark.parametrize("scale", [2, 3])
@pytest.mark.parametrize("where", ["top", "middle", "bottom"])
def test_band_upscale_planes_are_rows_of_the_whole_images(lenna_gray, scale, where):
    cfg = RaisrConfig(scale=scale)
    h_img, hb = 48, 20
    row0 = {"top": 0, "middle": 14, "bottom": h_img - hb}[where]
    x = torch.from_numpy(lenna_gray[:h_img, :40].astype(np.float32) / 255.0)[None]
    geo = plane_geometry(h_img, 40, cfg)
    whole = kupscale.upscale_planes(x, cfg, geo.hq, geo.wq, geo.hp)
    bgeo = plane_geometry(hb, 40, cfg)
    band = kupscale.upscale_planes(x[:, row0 : row0 + hb], cfg, bgeo.hq, bgeo.wq, bgeo.hp,
                                   row0, h_img)
    hp = geo.hp
    # plane row j of the band is plane row j + row0 of the image; its
    # sources lie in the band unless it is within a row of an inner edge
    lo = 0 if row0 == 0 else hp + 1
    hi = min(bgeo.hq, geo.hq - row0) if row0 + hb == h_img else hp + hb - 1
    assert torch.equal(band[:, :, lo:hi], whole[:, :, lo + row0 : hi + row0])
    # the kernel's compact row table reads the same rows with the same weights
    idx, wgt = kupscale.band_row_table(hb, scale, hp, bgeo.hq, row0, h_img)
    gidx, gwgt = kupscale.compact_axis_table(h_img, scale, hp, geo.hq, *kupscale.TILE[:1],
                                             *kupscale.SPAN[:1])
    np.testing.assert_array_equal(idx[..., lo:hi] + row0, gidx[..., lo + row0 : hi + row0])
    np.testing.assert_array_equal(wgt[..., lo:hi], gwgt[..., lo + row0 : hi + row0])


# ---------------------------------------------------------------------------
# (b) the 4-rank group: against the port's single-device ops and the JAX
# package's sharded functions
# ---------------------------------------------------------------------------


def _same(npz, name, want):
    got = npz[name]
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want)
    if "poisoned_" + name in npz:
        np.testing.assert_array_equal(npz["poisoned_" + name], got)


def test_histeq_global_sharded(npz, mesh4):
    g = npz["gray"]
    _same(npz, "histeq_global", ops.histeq_global(g, device="cpu").numpy())
    want = np.asarray(jax.jit(lambda x: jax_parallel.histeq_global_sharded(x, mesh4))(g))
    np.testing.assert_array_equal(npz["histeq_global"], want)


@pytest.mark.parametrize("clahe", [0, 2])
def test_histeq_local_sharded(npz, mesh4, clahe):
    g = npz["local"]
    block = ranks_body.BLOCK
    name = f"histeq_local_{clahe}"
    _same(npz, name, ops.histeq_local_block(g, blockshape=block, clahe_clip=clahe,
                                            device="cpu").numpy())
    want = np.asarray(jax.jit(lambda x: jax_parallel.histeq_local_sharded(
        x, mesh4, blockshape=block, clahe_clip=float(clahe)))(g))
    _within_one(npz[name], want, LOCAL_SHARE)


def test_motion_sharded(npz, mesh4):
    f0, f1 = npz["f0"], npz["f1"]
    _same(npz, "motion_fast", ops.estimate_motion_vector(f0, f1, method="fast",
                                                         device="cpu").numpy())
    _same(npz, "motion_exact", ops.estimate_motion_vector(f0, f1, method="exact",
                                                          device="cpu").numpy())
    _same(npz, "motion_exact_9_3", ops.estimate_motion_vector(f0, f1, 9, 3, method="exact",
                                                              device="cpu").numpy())
    fast = jax.jit(lambda a, b: jax_parallel.motion_fast_sharded(a, b, mesh4))(f0, f1)
    np.testing.assert_array_equal(npz["motion_fast"], np.asarray(fast))
    # the exact search's S-map program at 9/3 compiles in a second, at 15/5 in 15
    exact = jax.jit(lambda a, b: jax_parallel.motion_exact_sharded(
        a, b, mesh4, search_size=9, patch_size=3))(f0, f1)
    np.testing.assert_array_equal(npz["motion_exact_9_3"], np.asarray(exact))


def test_raisr_upsample_sharded(npz, mesh4, banks):
    model, jmodel = banks
    lr = npz["lr"]
    _same(npz, "raisr", raisr_upsample(torch.from_numpy(lr), model.filters, model.cfg).numpy())
    want = np.asarray(jax.jit(lambda x, f: jax_parallel.raisr_upsample_sharded(
        x, f, jmodel.cfg, mesh4))(lr, jmodel.filters))
    assert want.shape == npz["raisr"].shape
    assert psnr(npz["raisr"], want) > RAISR_PSNR


def test_raisr_upsample_sharded_shipped(npz, mesh4, banks):
    # fidelity='shipped': each band's bilinear upscale at the image's row
    # coordinates, equal to the single-device op bit for bit, and within one
    # level of the JAX package's single-device op
    model, jmodel = banks
    lr = npz["lr"]
    got = npz["raisr_shipped"]
    _same(npz, "raisr_shipped", raisr_upsample(torch.from_numpy(lr), None,
                                               ranks_body.SHIPPED).numpy())
    jcfg = JaxRaisrConfig(fidelity="shipped")
    _within_one(got, np.asarray(jax_raisr.raisr_upsample(lr, None, jcfg)), 1.0)
    # the JAX sharded function: within one level on every HR row whose
    # bilinear taps lie in its rank's rows. Its halo exchange hands a rank
    # its neighbours' far rows (the first rows of the rank below, the last of
    # the rank above), which only rows of 8 LR rows a rank (its own test's)
    # cannot show; the rows that read the halo are left out
    want = np.asarray(jax.jit(lambda x, f: jax_parallel.raisr_upsample_sharded(
        x, f, jcfg, mesh4))(lr, jmodel.filters))
    assert want.shape == got.shape
    h, s = lr.shape[0], jcfg.scale
    idx, wgt = axis_weights(h * s, h, "bilinear", dtype=np.float32)
    rank = np.arange(h * s) // (s * h // ranks_body.RANKS)
    inside = np.all((idx // (h // ranks_body.RANKS) == rank[:, None]) | (wgt == 0), axis=1)
    assert inside.mean() > 0.9
    _within_one(got[inside], want[inside], 1.0)


def test_raisr_train_step(npz):
    p, t, f = (npz[k] for k in ("patches", "targets", "fidx"))
    g, r, c = accumulate_normal_eq(torch.from_numpy(p), torch.from_numpy(t),
                                   torch.from_numpy(f), 864, 256)
    single = solve_filters(g, r, c, 11).numpy()
    np.testing.assert_allclose(npz["train"], single, **TRAIN_TOL)
    np.testing.assert_array_equal(npz["poisoned_train"], npz["train"])
    mesh22 = jax_parallel.make_mesh((2, 2), ("dp", "tp"), devices=jax.devices()[:4])
    want = jax.jit(lambda a, b, cc: jax_parallel.raisr_train_step(
        a, b, cc, 864, 11, mesh22, chunk=256))(p, t, f)
    np.testing.assert_allclose(npz["train"], np.asarray(want), **TRAIN_TOL)


def test_data_parallel_and_pipeline_sharded(npz, mesh4, banks):
    model, jmodel = banks
    batch = npz["batch"]
    _same(npz, "data_parallel", ops.histeq_global(batch, device="cpu").numpy())
    want = jax.jit(jax_parallel.data_parallel(jax_histeq.histeq_global, mesh4))(batch)
    np.testing.assert_array_equal(npz["data_parallel"], np.asarray(want))

    cfg = ranks_body.PIPE
    out, levels = EnhancePipeline(cfg, raisr_model=model)(batch[:4], device="cpu")
    _same(npz, "pipeline", out.numpy())
    for k, lv in enumerate(levels):
        _same(npz, f"pipeline_level{k}", lv.numpy())
    jcfg = JaxEnhanceConfig(equalize=cfg.equalize, superres=cfg.superres,
                            resize_to=cfg.resize_to, pyramid_depth=cfg.pyramid_depth)
    jout, jlevels = JaxEnhancePipeline(jcfg, raisr_model=jmodel).sharded(mesh4)(batch[:4])
    assert psnr(npz["pipeline"], np.asarray(jout)) > RAISR_PSNR
    for k, jlv in enumerate(jlevels):
        assert psnr(npz[f"pipeline_level{k}"], np.asarray(jlv)) > RAISR_PSNR


def test_dryrun_multichip(group_runs, npz):
    group_runs.dry()  # raises if a rank failed
    # the rank body's outputs, from the scenario's group
    bank = npz["dry_filters"]
    assert bank.shape == (864, 11, 11) and np.isfinite(bank).all()
    _same(npz, "dry_histeq_global", ops.histeq_global(npz["dry_gray"], device="cpu").numpy())
    _same(npz, "dry_histeq_local", ops.histeq_local_block(
        npz["dry_gray_local"], blockshape=(32, 32), device="cpu").numpy())
    _same(npz, "dry_raisr", raisr_upsample(torch.from_numpy(npz["dry_lr"]),
                                           torch.from_numpy(bank), RaisrConfig()).numpy())


def test_sharded_errors_match_jax(rng):
    # the checks run before any collective, so a stand-in mesh of the right
    # sizes reaches them; the JAX package asserts where the port raises
    # ValueError (the train step's bucket split and the RAISR halo)
    mesh8 = jax_parallel.make_mesh((8,), ("data",))
    fake8 = types.SimpleNamespace(shape={"data": 8}, coords={"data": 0},
                                  device=torch.device("cpu"))
    g = rng.integers(0, 256, (768, 512), dtype=np.uint8)
    for m, mod in ((mesh8, jax_parallel), (fake8, parallel)):
        with pytest.raises(ValueError, match="not divisible"):
            mod.histeq_local_sharded(g, m, blockshape=(256, 256))
    g = rng.integers(0, 256, (64, 64), dtype=np.uint8)  # 8 rows a shard
    for m, mod in ((mesh8, jax_parallel), (fake8, parallel)):
        with pytest.raises(ValueError, match="halo"):
            mod.motion_fast_sharded(g, g, m)
        with pytest.raises(ValueError, match="halo"):
            mod.motion_exact_sharded(g[:32], g[:32], m)
        with pytest.raises(ValueError, match="not divisible"):
            mod.motion_fast_sharded(g[:60], g[:60], m)
    p = np.zeros((64, 121), np.float32)
    t, f = np.zeros(64, np.float32), np.zeros(64, np.int32)
    mesh42 = jax_parallel.make_mesh((4, 2), ("dp", "tp"))
    with pytest.raises(AssertionError):
        jax_parallel.raisr_train_step(p, t, f, 865, 11, mesh42)
    fake42 = types.SimpleNamespace(shape={"dp": 4, "tp": 2}, coords={"dp": 0, "tp": 0},
                                   device=torch.device("cpu"))
    with pytest.raises(ValueError, match="num_filters 865 not divisible by tp 2"):
        parallel.raisr_train_step(p, t, f, 865, 11, fake42)
    lr = np.zeros((64, 32), np.uint8)
    with pytest.raises(AssertionError):
        jax_parallel.raisr_upsample_sharded(lr, jnp.zeros((864, 11, 11)),
                                            JaxRaisrConfig(fidelity="full"), mesh8, halo=3)
    for fidelity in ("full", "shipped"):
        with pytest.raises(ValueError, match="halo 3 is below the 6 LR rows"):
            parallel.raisr_upsample_sharded(lr, np.zeros((864, 11, 11), np.float32),
                                            RaisrConfig(fidelity=fidelity), fake8, halo=3)
    with pytest.raises(AssertionError):
        jax_parallel.raisr_upsample_sharded(lr, jnp.zeros((864, 11, 11)),
                                            JaxRaisrConfig(fidelity="shipped"), mesh8, halo=3)


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        parallel.make_mesh(device="cpu")
