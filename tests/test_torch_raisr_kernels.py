"""PyTorch port: each kernel's plain version against the JAX package on the
CPU (upscale vs the XLA twin, hash vs the XLA twin, apply vs the Pallas
kernel in interpret mode). The CUDA kernels themselves are held against
these plain versions on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oclcomputervision_tpu.ops import raisr as jax_raisr
from oclcomputervision_tpu.ops.pallas import raisr_pallas
from oclcomputervision_tpu.utils.config import RaisrConfig
from oclcomputervision_tpu_torch.kernels import raisr as kraisr
from oclcomputervision_tpu_torch.kernels import upscale as kupscale
from oclcomputervision_tpu_torch.ops import raisr as port

torch.set_num_threads(2)


@pytest.mark.parametrize("s,h,w", [(2, 100, 130), (3, 64, 80), (4, 50, 70)])
def test_upscale_planes_matches_jax_twin(s, h, w):
    # <= 1 f32 ULP: the port rounds every product and sum, XLA:CPU contracts
    # multiply-adds into FMAs (tests/test_pallas.py's bound for the TPU kernel)
    cfg = RaisrConfig(scale=s)
    geo = port.plane_geometry(h, w, cfg)
    x = np.random.default_rng(s).random((2, h, w), np.float32)
    want = np.asarray(
        jax_raisr.upscale_planes(
            jnp.asarray(x), cfg, geo.h2p, geo.w2p, geo.hq, geo.wq, geo.hp
        )
    )
    got = kupscale.upscale_planes(torch.from_numpy(x), cfg, geo.hq, geo.wq, geo.hp)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == want.shape == (2, s * s, geo.hq, geo.wq)
    assert np.abs(got.numpy() - want).max() <= 1.2e-7


@pytest.mark.parametrize("content", ["lenna", "random"])
def test_hash_planes_matches_jax_twin(lenna_gray, content):
    # >= 0.9999 bucket agreement: only pixels within float rounding of a
    # quantizer boundary (atan2 and sum-order ULPs) may differ. Uniformly
    # random luma puts many pixels near a boundary: the TPU kernel's default
    # form falls below 0.9999 on it, the plain version keeps the twin's order.
    cfg = RaisrConfig(fidelity="full")
    if content == "lenna":
        img = lenna_gray[:128, :128].astype(np.float32) / 255.0
    else:
        img = np.random.default_rng(11).random((128, 128), np.float32)
    geo = port.plane_geometry(128, 128, cfg)
    planes = np.array(
        jax_raisr.upscale_planes(
            jnp.asarray(img[None]), cfg, geo.h2p, geo.w2p, geo.hq, geo.wq, geo.hp
        )
    )
    want = np.asarray(
        jax_raisr.hash_planes(jnp.asarray(planes), cfg, geo.hp, geo.h2p, geo.w2p)
    )
    got = kraisr.hash_planes(torch.from_numpy(planes), cfg, geo.hp, geo.h2p, geo.w2p)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    assert int(got.min()) >= 0 and int(got.max()) < 216
    assert (got.numpy() == want).mean() >= 0.9999


@pytest.fixture(scope="module")
def apply_case():
    cfg = RaisrConfig(fidelity="full")
    s, h2, w2 = cfg.scale, 64, 128
    rng = np.random.default_rng(7)
    planes = rng.random((2, s * s, h2 + 8, w2 + 128), dtype=np.float32)
    buckets = rng.integers(0, 216, (1, s * s, h2, w2)).astype(np.int32)
    filters = (rng.standard_normal((cfg.num_filters, 11, 11)) * 0.05).astype(np.float32)
    # two channels stacked over one bucket map, as the colour path runs it
    got = kraisr.apply_filters_planes(
        torch.from_numpy(planes), torch.from_numpy(buckets),
        torch.from_numpy(filters), cfg,
    ).numpy()
    return cfg, planes, buckets, filters, got


@pytest.mark.parametrize("phase", range(4))
def test_apply_matches_pallas_kernel(apply_case, phase):
    # bf16 taps and bank, products exact in f32: only the summation order
    # differs from the TPU kernel's matrix product
    cfg, planes, buckets, filters, got = apply_case
    s = cfg.scale
    py, px = divmod(phase, s)
    hp = raisr_pallas.plane_halo(cfg.filter_len, s, cfg.gauss_len)
    wmat = raisr_pallas._phase_wmats(jnp.asarray(filters), cfg)[phase]
    bucket_t = jnp.asarray(np.concatenate([buckets[:, phase]] * 2))
    want = np.asarray(
        raisr_pallas._apply_phase(
            jnp.asarray(planes), bucket_t, wmat, cfg.filter_len, s, py, px, hp,
            interpret=True, variant="base",
        )
    )
    assert got.shape == (2, s * s, 64, 128)
    assert np.abs(got[:, phase] - want).max() <= 2e-5


def test_apply_out_of_range_bucket_gives_zero():
    # the TPU kernel's one-hot select matches no bucket row: output 0
    cfg = RaisrConfig()
    rng = np.random.default_rng(1)
    planes = torch.from_numpy(rng.random((1, 4, 20, 40), dtype=np.float32))
    buckets = torch.from_numpy(rng.integers(0, 216, (1, 4, 8, 16)).astype(np.int32))
    buckets[0, 1, 2, 3] = 216
    buckets[0, 2, 0, 0] = -1
    filters = torch.ones((cfg.num_filters, 11, 11))
    out = kraisr.apply_filters_planes(planes, buckets, filters, cfg)
    assert out[0, 1, 2, 3] == 0 and out[0, 2, 0, 0] == 0
    assert (out[0, 0] > 0).all()


@pytest.mark.parametrize("s, fl", [(2, 17), (3, 25)])
def test_plain_apply_matches_jax_apply_filters_at_banks_too_large_for_a_block(s, fl):
    # the configs the split form runs on the card (5 strength quantizers,
    # 432 buckets: one phase's bank fits no block): the plain apply in plane
    # space against the JAX package's full-resolution XLA apply_filters (one
    # gathered filter per pixel, edge-padded taps), fed an image and a bank
    # already rounded to bf16 as the plain version rounds them. Products of
    # bf16 values are exact in f32 and both sum the taps in order from 0.
    cfg = RaisrConfig(scale=s, filter_len=fl, num_strength=6,
                      strength_quantizers=(1e-5, 1e-4, 1e-3, 1e-2, 1e-1))
    nbk = cfg.num_angle * cfg.num_strength * cfg.num_coherence
    h, w = 7, 6
    big_h, big_w = s * h, s * w
    rng = np.random.default_rng(fl)

    def bf16(a):
        return torch.from_numpy(a).to(torch.bfloat16).float().numpy()

    up = bf16(rng.random((big_h, big_w), np.float32))
    bank = bf16(rng.normal(0.0, 0.05, (cfg.num_filters, fl, fl)).astype(np.float32))
    bucket = rng.integers(0, nbk, (big_h, big_w)).astype(np.int32)
    yy, xx = np.mgrid[0:big_h, 0:big_w]
    fidx = bucket * s * s + (yy % s) * s + xx % s  # filter k * s*s + t, t the pixel type
    want = np.asarray(jax_raisr.apply_filters(jnp.asarray(up), jnp.asarray(fidx),
                                              jnp.asarray(bank), cfg))
    hp = port.plane_halo(fl, s, cfg.gauss_len)
    assert s * hp >= fl // 2
    # plane a*s + b, element (i, j): full-res (s (i - hp) + a, s (j - hp) + b)
    padded = np.pad(up, s * hp, mode="edge")
    planes = padded.reshape(h + 2 * hp, s, w + 2 * hp, s).transpose(1, 3, 0, 2)
    buckets = bucket.reshape(h, s, w, s).transpose(1, 3, 0, 2)
    got = kraisr.apply_filters_planes(
        torch.from_numpy(planes.reshape(1, s * s, h + 2 * hp, w + 2 * hp).copy()),
        torch.from_numpy(buckets.reshape(1, s * s, h, w).copy()), torch.from_numpy(bank), cfg,
    ).numpy()
    got = got.reshape(s, s, h, w).transpose(2, 0, 3, 1).reshape(big_h, big_w)
    np.testing.assert_array_equal(got, want)
