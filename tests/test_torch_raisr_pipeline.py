"""PyTorch port: the RAISR slice end to end on the CPU, against the JAX
package's plane-native pipeline (Pallas kernels in interpret mode) and the
numpy oracle, plus the bank carried across from a JAX model."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oclcomputervision_tpu.models.raisr import RaisrModel as JaxRaisrModel
from oclcomputervision_tpu.oracle import raisr as oracle_raisr
from oclcomputervision_tpu.ops.pallas import raisr_pallas
from oclcomputervision_tpu.ops.raisr import _raisr_planes_batched
from oclcomputervision_tpu.ops.raisr import raisr_upsample as jax_raisr_upsample
from oclcomputervision_tpu.utils import asset_path, psnr
from oclcomputervision_tpu.utils.config import RaisrConfig
from oclcomputervision_tpu_torch.entry import entry
from oclcomputervision_tpu_torch.kernels import raisr as kraisr
from oclcomputervision_tpu_torch.models.raisr import RaisrModel
from oclcomputervision_tpu_torch.ops.raisr import raisr_upsample

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jax_x2():
    return JaxRaisrModel.load(asset_path("raisr_filters_x2.npz"))


@pytest.fixture(scope="module")
def port_x2(jax_x2):
    return RaisrModel.from_numpy(np.asarray(jax_x2.filters), jax_x2.cfg, "cpu")


@pytest.mark.parametrize("color", ["gray", "rgb"])
def test_slice_matches_jax_pipeline(color, lenna_gray, lenna_rgb, jax_x2, port_x2):
    # hash buckets may flip where float rounding straddles a quantizer
    # boundary (atan2 here, a ratio test in the TPU kernel): a handful of
    # pixels get a different, valid filter
    img = (lenna_gray if color == "gray" else lenna_rgb)[:64, :100]
    nchan = 1 if color == "gray" else 3
    want = np.asarray(
        _raisr_planes_batched(
            jnp.asarray(img)[None], jax_x2.filters, jax_x2.cfg, nchan, interpret=True
        )
    )[0]
    got = port_x2.upsample(img)
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    got = got.numpy()
    diff = np.abs(got.astype(int) - want.astype(int))
    assert (diff <= 1).mean() >= 0.999
    assert psnr(got, want) > 45
    oracle = oracle_raisr.raisr_upsample(
        img, np.asarray(jax_x2.filters, np.float64), jax_x2.cfg
    )
    assert psnr(got, oracle) > 35


def test_bank_carried_across_from_jax(jax_x2, port_x2):
    loaded = RaisrModel.load(asset_path("raisr_filters_x2.npz"), device="cpu")
    # the JAX config crossed by its fields into the port's own class
    assert loaded.cfg == port_x2.cfg
    assert type(port_x2.cfg) is not type(jax_x2.cfg)
    assert dataclasses.asdict(port_x2.cfg) == dataclasses.asdict(jax_x2.cfg)
    assert loaded.filters.dtype == torch.float32
    np.testing.assert_array_equal(loaded.filters.numpy(), port_x2.filters.numpy())
    np.testing.assert_array_equal(loaded.filters.numpy(), np.asarray(jax_x2.filters))
    # the per-phase bf16 rows are the TPU kernel's weight matrices' live block
    rows = kraisr.phase_rows(port_x2.filters, port_x2.cfg).float().numpy()
    wmats = raisr_pallas._phase_wmats(jax_x2.filters, jax_x2.cfg)
    for t, wmat in enumerate(wmats):
        want = np.asarray(wmat.astype(jnp.float32))[:216, :121]
        np.testing.assert_array_equal(rows[t], want)


@pytest.mark.parametrize("scale", [3, 4])
def test_other_scales_match_oracle(scale, lenna_gray):
    jm = JaxRaisrModel.load(asset_path(f"raisr_filters_x{scale}.npz"))
    model = RaisrModel.load(asset_path(f"raisr_filters_x{scale}.npz"), device="cpu")
    img = lenna_gray[100:148, 200:260]
    got = model.upsample(img).numpy()
    assert got.shape == (48 * scale, 60 * scale)
    want = oracle_raisr.raisr_upsample(img, np.asarray(jm.filters, np.float64), jm.cfg)
    assert psnr(got, want) > 35


def test_ct_blend_matches_oracle(lenna_gray, jax_x2, port_x2):
    cfg = dataclasses.replace(port_x2.cfg, blend="ct")
    img = lenna_gray[200:248, 100:164]
    got = raisr_upsample(torch.from_numpy(img), port_x2.filters, cfg).numpy()
    plain = port_x2.upsample(img).numpy()
    want = oracle_raisr.raisr_upsample(img, np.asarray(jax_x2.filters, np.float64), cfg)
    assert psnr(got, want) > 35
    assert not np.array_equal(got, plain)  # the blend did something


def test_config_outside_the_compiled_forms_matches_jax_xla_twin(lenna_gray):
    # filter_len 7, gauss_len 7 and 5 strength quantizers: on the card the
    # generic hash and apply run it; here their plain versions, against the
    # JAX package's XLA path (interleaved resize, hash and apply) on the CPU
    cfg = RaisrConfig(filter_len=7, gauss_len=7, num_strength=6,
                      strength_quantizers=(1e-5, 1e-4, 1e-3, 1e-2, 1e-1))
    rng = np.random.default_rng(7)
    bank = rng.normal(0.0, 0.02, (cfg.num_filters, 7, 7)).astype(np.float32)
    bank[:, 3, 3] += 1.0
    img = lenna_gray[240:272, 240:272]
    want = np.asarray(jax_raisr_upsample(jnp.asarray(img), jnp.asarray(bank), cfg))
    model = RaisrModel.from_numpy(bank, cfg, "cpu")
    assert kraisr.hash_form(model.cfg) == "raisr_hash_generic"
    assert kraisr.apply_form(model.cfg, 128) == "raisr_apply_generic"
    got = model.upsample(img).numpy()
    assert got.shape == want.shape == (64, 64)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert (diff <= 1).mean() >= 0.999
    assert psnr(got, want) > 45


def test_batched_equals_single_and_bgra_alpha_passes_through(lenna_rgb, port_x2):
    rng = np.random.default_rng(3)
    rgb = lenna_rgb[:40, :56]
    alpha = rng.integers(0, 256, rgb.shape[:2], dtype=np.uint8)
    bgra = np.concatenate([rgb, alpha[..., None]], axis=-1)
    batch = np.stack([rgb, rgb[::-1].copy()])
    out = port_x2.upsample(batch).numpy()
    assert out.shape == (2, 80, 112, 3)
    np.testing.assert_array_equal(out[0], port_x2.upsample(rgb).numpy())
    np.testing.assert_array_equal(out[1], port_x2.upsample(batch[1]).numpy())
    # alpha rides the batch as a fourth channel: colour output unchanged
    out4 = port_x2.upsample(bgra).numpy()
    assert out4.shape == (80, 112, 4)
    np.testing.assert_array_equal(out4[..., :3], out[0])


def test_entry_and_unported_paths(port_x2):
    fn, args = entry("cpu")
    out = fn(*args)
    assert tuple(out.shape) == (128, 128) and out.dtype == torch.uint8
    cfg = RaisrConfig(fidelity="full")
    want = oracle_raisr.raisr_upsample(
        args[0].numpy(), args[1].numpy().astype(np.float64), cfg
    )
    assert psnr(out.numpy(), want) > 35
    shipped = dataclasses.replace(port_x2.cfg, fidelity="shipped")
    with pytest.raises(NotImplementedError, match="queue A item 5"):
        raisr_upsample(args[0], port_x2.filters, shipped)
    with pytest.raises(TypeError):
        raisr_upsample(args[0].numpy(), port_x2.filters, cfg)
    # no card here: the default device (the card) raises, never the CPU
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        entry()
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        RaisrModel.load(asset_path("raisr_filters_x2.npz"))
