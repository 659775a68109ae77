"""PyTorch port: RAISR ``fidelity='shipped'`` and the RAISR trainer on the
CPU, against the JAX package. The trainer's stages are held apart on shared
inputs (the features, then the normal equations fed the JAX package's own
features, then the solve fed its own G and r), and the whole by the output
of the banks it makes. On the card, chip_smoke.py holds the features through
the upscale and hash kernels to their plain versions.

Run as a script (``python tests/test_torch_raisr_train.py``), it records the
frame11 PSNR that chip_smoke.py's trainer phase is held to: the JAX
package's ``train_filters`` on ``chip_smoke.train_corpus()`` at
``RaisrConfig()`` with ``augment='starved'``, upsampled through the JAX
``raisr_upsample`` on the CPU.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# run as a script, the repository root is not on the path (conftest.py puts it there for pytest)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from oclcomputervision_tpu.models import raisr as jax_models
from oclcomputervision_tpu.ops.raisr import raisr_upsample as jax_raisr_upsample
from oclcomputervision_tpu.utils import psnr
from oclcomputervision_tpu.utils.config import RaisrConfig as JaxRaisrConfig
from oclcomputervision_tpu_torch.models import raisr as port_models
from oclcomputervision_tpu_torch.ops.raisr import raisr_upsample
from oclcomputervision_tpu_torch.utils import asset_path, load_gray, load_image
from oclcomputervision_tpu_torch.utils.config import RaisrConfig

torch.set_num_threads(2)

WITHIN_ONE = 0.999  # share of output values within one level
FIDX_AGREEMENT = 0.9999  # the hash's contract (PARITY.md C10)


@pytest.fixture(scope="module", autouse=True)
def _drop_jax_programs():
    yield
    jax.clear_caches()


def _within_one(a, b) -> float:
    return float((np.abs(np.asarray(a, int) - np.asarray(b, int)) <= 1).mean())


# ---------------------------------------------------------------------------
# fidelity='shipped'
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("color", ["gray", "rgb", "bgra", "gray_stack"])
@pytest.mark.parametrize("scale", [2, 3])
def test_shipped_matches_jax(color, scale):
    rgb = load_image("lenna.png")[200:248, 220:276]
    alpha = np.random.default_rng(scale).integers(0, 256, rgb.shape[:2], dtype=np.uint8)
    img = {
        "gray": load_gray("lenna.png")[200:248, 220:276],
        "rgb": rgb,
        "bgra": np.concatenate([rgb[..., ::-1], alpha[..., None]], -1),
        "gray_stack": np.stack([rgb[..., 0], rgb[..., 1]]),
    }[color]
    img = np.ascontiguousarray(img)
    cfg = RaisrConfig(scale=scale, fidelity="shipped")
    got = raisr_upsample(torch.from_numpy(img), None, cfg).numpy()
    want = np.asarray(jax_raisr_upsample(img, None, JaxRaisrConfig(scale=scale, fidelity="shipped")))
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert _within_one(got, want) >= WITHIN_ONE
    if color == "bgra":  # alpha passes the YUV round trip untouched
        np.testing.assert_array_equal(got[..., 3], want[..., 3])


def test_shipped_model_load_ignores_the_bank():
    path = asset_path("raisr_filters_x2.npz")
    model = port_models.RaisrModel.load(path, fidelity="shipped", device="cpu")
    img = load_gray("lenna.png")[:40, :56]
    got = model.upsample(img).numpy()
    want = np.asarray(jax_models.RaisrModel.load(path, fidelity="shipped").upsample(img))
    assert _within_one(got, want) >= WITHIN_ONE
    np.testing.assert_array_equal(got, raisr_upsample(torch.from_numpy(img), None, model.cfg).numpy())


# ---------------------------------------------------------------------------
# The trainer's stages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fl", [5, 11])
def test_extract_patches_equal(fl):
    img = np.random.default_rng(fl).random((13, 17), dtype=np.float32)
    got = port_models.extract_patches(torch.from_numpy(img), fl).numpy()
    want = np.asarray(jax_models.extract_patches(jnp.asarray(img), fl))
    np.testing.assert_array_equal(got, want)


def _luma01(y0: int, x0: int, h: int, w: int) -> np.ndarray:
    return (load_gray("lenna.png")[y0 : y0 + h, x0 : x0 + w].astype(np.float64) / 255.0).astype(
        np.float32
    )


@pytest.fixture(scope="module", params=[2, 3], ids=["x2", "x3"])
def features(request):
    """(scale, the port's and the JAX package's features of lenna 64^2, and
    the JAX package's normal equations of its features)."""
    s = request.param
    y = _luma01(0, 0, 64, 64 if s == 2 else 67)  # x3: a width the scale does not divide
    port = port_models._training_arrays(torch.from_numpy(y), RaisrConfig(scale=s))
    jax_side = [np.asarray(t) for t in jax_models._training_arrays(jnp.asarray(y), JaxRaisrConfig(scale=s))]
    normal_eq = jax_models.accumulate_normal_eq(*jax_side, RaisrConfig(scale=s).num_filters)
    return s, [t.numpy() for t in port], jax_side, [np.asarray(t) for t in normal_eq]


def test_training_arrays_match_jax(features):
    _, (p, t, f), (jp, jt, jf), _ = features
    assert p.shape == jp.shape and p.dtype == np.float32
    np.testing.assert_allclose(p, jp, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(t, jt)
    assert (f == jf).mean() >= FIDX_AGREEMENT


def test_fidx_equals_jax_hash_of_the_same_upscale():
    # JAX's jitted _training_arrays contracts the hash's f32 expressions
    # differently from its own op-by-op hash_image, and so lands 2 pixels
    # of this crop across an angle boundary (within the 0.9999 contract);
    # on the same upscale the port's buckets equal hash_image's
    from oclcomputervision_tpu.oracle.raisr import pixel_type_map
    from oclcomputervision_tpu.ops.raisr import hash_image

    y = _luma01(180, 200, 64, 64)
    p, _, f = port_models._training_arrays(torch.from_numpy(y), RaisrConfig())
    up = p.numpy()[:, p.shape[1] // 2].reshape(64, 64)  # the centre tap is the upscale
    bucket = np.asarray(hash_image(jnp.asarray(up), JaxRaisrConfig()))
    want = bucket * 4 + pixel_type_map(64, 64, 2)
    np.testing.assert_array_equal(f.numpy(), want.reshape(-1))


@pytest.mark.parametrize("chunk", [1024, 37])
def test_accumulate_matches_jax(features, chunk):
    s, _, (jp, jt, jf), (jg, jr, jc) = features
    nf = RaisrConfig(scale=s).num_filters
    g, r, cnt = port_models.accumulate_normal_eq(
        torch.from_numpy(jp.copy()), torch.from_numpy(jt.copy()), torch.from_numpy(jf.copy()),
        nf, chunk,
    )
    assert g.shape == jg.shape and r.shape == jr.shape and cnt.dtype == torch.float32
    np.testing.assert_allclose(g.numpy(), jg, rtol=0, atol=1e-5 * np.abs(jg).max())
    np.testing.assert_allclose(r.numpy(), jr, rtol=0, atol=1e-5 * np.abs(jr).max())
    np.testing.assert_array_equal(cnt.numpy(), jc)


def test_accumulate_rejects_an_index_past_the_bank():
    p = torch.zeros((3, 4))
    with pytest.raises(ValueError, match="filter index"):
        port_models.accumulate_normal_eq(p, torch.zeros(3), torch.tensor([0, 1, 9]), 8)


@pytest.mark.parametrize("ridge", [0.004, 0.03])
def test_solve_matches_jax(features, ridge):
    s, _, _, (jg, jr, jc) = features
    nf = RaisrConfig(scale=s).num_filters
    want = np.asarray(jax_models.solve_filters(jg, jr, jc, 11, ridge))
    got = port_models.solve_filters(
        *(torch.from_numpy(a.copy()) for a in (jg, jr, jc)), 11, ridge
    ).numpy()
    assert got.shape == want.shape == (nf, 11, 11)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)


def test_dihedral_transforms_equal():
    img = np.arange(12, dtype=np.float64).reshape(3, 4)
    got, want = port_models.dihedral_transforms(img), jax_models.dihedral_transforms(img)
    assert len(got) == len(want) == 8
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert port_models.RIDGE_BY_SCALE == jax_models.RIDGE_BY_SCALE


# ---------------------------------------------------------------------------
# The trainer end to end: the banks' outputs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("augment", [False, True, "starved"])
def test_train_filters_banks_agree_with_jax(augment):
    # an RGB crop (luma formed on the host in float64) and a gray one that
    # is not square, so the dihedral variants change the geometry
    corpus = [load_image("lenna.png")[100:164, 120:184], load_gray("lenna.png")[400:448, 0:64]]
    cfg = RaisrConfig()
    got = port_models.train_filters(corpus, cfg, augment=augment, device="cpu")
    want = np.asarray(jax_models.train_filters(corpus, JaxRaisrConfig(), augment=augment))
    assert got.shape == want.shape and got.dtype == torch.float32
    # a held-out crop, degraded as examples/train_banks.py does
    hr = load_gray("lenna.png")[300:364, 280:344]
    lr = hr.reshape(32, 2, 32, 2).mean(axis=(1, 3)).round().astype(np.uint8)
    out_port = port_models.RaisrModel(cfg, got).upsample(lr).numpy()
    out_jax = port_models.RaisrModel.from_numpy(want, cfg, "cpu").upsample(lr).numpy()
    assert _within_one(out_port, out_jax) >= WITHIN_ONE
    assert abs(psnr(out_port, hr) - psnr(out_jax, hr)) < 0.05


def test_model_train_and_save_load_cross_packages(tmp_path):
    cfg = RaisrConfig(scale=3)
    model = port_models.RaisrModel(cfg).train([load_gray("lenna.png")[:48, :60]], device="cpu")
    assert model.filters.shape == (cfg.num_filters, 11, 11)
    port_path, jax_path = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    model.save(port_path)
    jm = jax_models.RaisrModel.load(port_path)
    np.testing.assert_array_equal(np.asarray(jm.filters), model.filters.numpy())
    assert dataclasses.asdict(jm.cfg) == dataclasses.asdict(model.cfg)
    jm.save(jax_path)
    back = port_models.RaisrModel.load(jax_path, device="cpu")
    np.testing.assert_array_equal(back.filters.numpy(), model.filters.numpy())
    assert back.cfg == model.cfg
    with np.load(port_path) as a, np.load(jax_path) as b:
        assert a["cfg"].dtype == b["cfg"].dtype
        np.testing.assert_array_equal(a["cfg"], b["cfg"])


def test_model_keeps_nn_module_modes_and_its_banks_device():
    cfg = RaisrConfig(scale=3)
    bank = torch.zeros((cfg.num_filters, 11, 11))
    model = port_models.RaisrModel(cfg, bank)
    assert model.eval() is model and not model.training
    assert model.train() is model and model.training
    parent = torch.nn.Sequential(model).eval()
    assert not parent.training and not model.training
    # with no device= the new bank stays where the old one was
    model.train([load_gray("lenna.png")[:48, :60]])
    assert model.filters.device.type == "cpu" and not torch.equal(model.filters, bank)


def test_trainer_runs_on_the_card_unless_cpu_is_asked():
    with pytest.raises(RuntimeError, match="cuda"):
        port_models.train_filters([load_gray("lenna.png")[:32, :32]])
    with pytest.raises(ValueError, match="no filter bank"):
        port_models.RaisrModel().upsample(np.zeros((8, 8), np.uint8))


def record_frame11():
    """The JAX package's x2 bank from chip_smoke.train_corpus() and its PSNR
    on frame11 (chip_smoke.degrade), beside bicubic's: the figure
    chip_smoke.py's trainer phase holds the card's bank to."""
    import chip_smoke
    from oclcomputervision_tpu.ops.interpolation import resize_uint8

    jax.config.update("jax_platforms", "cpu")
    cfg = JaxRaisrConfig()
    bank = jax_models.train_filters(chip_smoke.train_corpus(), cfg, augment="starved")
    hr, lr = chip_smoke.degrade(load_gray("frame11.png"), cfg.scale)
    sr = np.asarray(jax_raisr_upsample(lr, bank, cfg))
    bic = np.asarray(resize_uint8(lr, hr.shape, "bicubic"))
    print(f"frame11 x2 PSNR: JAX-trained bank {psnr(sr, hr)!r} dB, bicubic {psnr(bic, hr)!r} dB")


if __name__ == "__main__":
    record_frame11()
