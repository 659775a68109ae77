"""PyTorch port: the image-domain and plane RAISR ops of ``ops/raisr.py``
(``hash_components``, ``hash_image``, ``pixel_type_map``, ``apply_filters``,
``apply_filters_fast``, ``ct_blend_weights``, ``upscale_planes``,
``hash_planes``) against the JAX package's on the CPU, at x2 and x3 on one
tiny shape: 24 x 40 LR (lenna, with a flat patch and a seeded noise patch),
its bilinear upscale, banks and 3-channel images from the seed.

Tolerances: pixel types and census weights equal; the upscale planes within
1 f32 ULP (XLA:CPU contracts multiply-adds into FMAs); bucket agreement at
least 0.9999 (only pixels within float rounding of a quantizer edge may
differ); the applies within 1e-5 on [0, 1] data.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oclcomputervision_tpu.ops import raisr as jax_raisr
from oclcomputervision_tpu.ops.interpolation import _resize_plane as jax_resize_plane
from oclcomputervision_tpu.utils.config import RaisrConfig as JaxRaisrConfig
from oclcomputervision_tpu_torch.ops import raisr as port_raisr
from oclcomputervision_tpu_torch.utils import load_gray
from oclcomputervision_tpu_torch.utils.config import RaisrConfig

SCALES = (2, 3)
LR_SHAPE = (24, 40)
AGREEMENT = 0.9999
APPLY_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _drop_jax_programs():
    yield
    jax.clear_caches()


@pytest.fixture(scope="module", params=SCALES, ids=lambda s: f"x{s}")
def case(request):
    """Per scale: both configs, the LR image in [0, 1], its upscale, the
    JAX hash components and a seeded bank and 3-channel image."""
    s = request.param
    rng = np.random.default_rng(s)
    h, w = LR_SHAPE
    lr = load_gray("lenna.png")[240 : 240 + h, 240 : 240 + w].astype(np.float32) / 255.0
    lr[:6, :8] = 0.5  # flat: zero structure tensor
    lr[-6:, -8:] = rng.random((6, 8), dtype=np.float32)
    up = np.asarray(jax_resize_plane(jnp.asarray(lr)[..., None], (s * h, s * w), "bilinear"))
    cfg = RaisrConfig(scale=s)
    fl = cfg.filter_len
    return {
        "cfg": cfg,
        "jcfg": JaxRaisrConfig(scale=s),
        "lr": lr,
        "up": np.array(up[..., 0]),
        "up3": rng.random((s * h, s * w, 3), dtype=np.float32),
        "comps": [np.array(c) for c in jax_raisr.hash_components(jnp.asarray(up[..., 0]),
                                                                  JaxRaisrConfig(scale=s))],
        "filters": (rng.standard_normal((cfg.num_filters, fl, fl)) * 0.05).astype(np.float32),
    }


def _agree(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape and got.dtype == torch.int32
    assert (got.numpy() == want).mean() >= AGREEMENT


def test_hash_components(case):
    got = port_raisr.hash_components(torch.from_numpy(case["up"]), case["cfg"])
    assert len(got) == 3
    for g, want in zip(got, case["comps"]):
        _agree(g, want)


def test_hash_image(case):
    got = port_raisr.hash_image(torch.from_numpy(case["up"]), case["cfg"])
    _agree(got, jax_raisr.hash_image(jnp.asarray(case["up"]), case["jcfg"]))


def test_pixel_type_map(case):
    h, w = case["up"].shape
    s = case["cfg"].scale
    got = port_raisr.pixel_type_map(h, w, s, device="cpu")
    want = np.asarray(jax_raisr.pixel_type_map(h, w, s))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _fidx(case) -> np.ndarray:
    cfg = case["cfg"]
    ai, si, ci = case["comps"]
    bucket = (ai * cfg.num_strength + si) * cfg.num_coherence + ci
    h, w = bucket.shape
    return bucket * cfg.num_pixel_type + np.asarray(jax_raisr.pixel_type_map(h, w, cfg.scale))


@pytest.mark.parametrize("image", ["up", "up3"], ids=["gray", "three_channels"])
def test_apply_filters(case, image):
    x, fidx, bank = case[image], _fidx(case), case["filters"]
    got = port_raisr.apply_filters(torch.from_numpy(x), torch.from_numpy(fidx),
                                   torch.from_numpy(bank), case["cfg"])
    want = np.asarray(jax_raisr.apply_filters(jnp.asarray(x), jnp.asarray(fidx),
                                              jnp.asarray(bank), case["jcfg"]))
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=APPLY_TOL)


@pytest.mark.parametrize("image", ["up", "up3"], ids=["gray", "three_channels"])
def test_apply_filters_fast(case, image):
    x, bank = case[image], case["filters"]
    got = port_raisr.apply_filters_fast(torch.from_numpy(x),
                                        *(torch.from_numpy(c) for c in case["comps"]),
                                        torch.from_numpy(bank), case["cfg"])
    want = np.asarray(jax_raisr.apply_filters_fast(jnp.asarray(x),
                                                   *(jnp.asarray(c) for c in case["comps"]),
                                                   jnp.asarray(bank), case["jcfg"]))
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=APPLY_TOL)
    # the phase split selects the pixel's own filter: the gather form's result
    slow = port_raisr.apply_filters(torch.from_numpy(x), torch.from_numpy(_fidx(case)),
                                    torch.from_numpy(bank), case["cfg"])
    np.testing.assert_allclose(got.numpy(), slow.numpy(), rtol=0, atol=APPLY_TOL)


def test_ct_blend_weights(case):
    # a batch of two: leading dims pass through
    x = np.stack([case["up"], case["up3"][..., 0]])
    got = port_raisr.ct_blend_weights(torch.from_numpy(x))
    want = np.asarray(jax_raisr.ct_blend_weights(jnp.asarray(x)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def _planes_geometry(case):
    geo = port_raisr.plane_geometry(*LR_SHAPE, case["cfg"])
    return geo.h2p, geo.w2p, geo.hq, geo.wq, geo.hp


@pytest.mark.parametrize("lead", [(), (2,)], ids=["single", "batch"])
def test_upscale_planes(case, lead):
    x = case["lr"] if not lead else np.stack([case["lr"], case["lr"][::-1, ::-1]])
    geo = _planes_geometry(case)
    got = port_raisr.upscale_planes(torch.from_numpy(np.ascontiguousarray(x)), case["cfg"],
                                    *geo)
    want = np.asarray(jax_raisr.upscale_planes(jnp.asarray(x), case["jcfg"], *geo))
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    ulp = np.spacing(np.abs(want).astype(np.float32))
    assert (np.abs(got.numpy() - want) <= ulp).all()


def test_upscale_planes_width_not_a_multiple_of_4(case):
    # the CUDA form takes widths that are multiples of 4: the op computes
    # wider planes and crops, and a column does not depend on the width
    h2p, w2p, hq, wq, hp = _planes_geometry(case)
    x = torch.from_numpy(case["lr"])
    narrow = port_raisr.upscale_planes(x, case["cfg"], h2p, w2p, hq, wq - 3, hp)
    wide = port_raisr.upscale_planes(x, case["cfg"], h2p, w2p, hq, wq, hp)
    assert tuple(narrow.shape[-1:]) == (wq - 3,)
    assert torch.equal(narrow, wide[..., : wq - 3])


def test_hash_planes(case):
    h2p, w2p, hq, wq, hp = _planes_geometry(case)
    x = np.stack([case["lr"], case["lr"][::-1, ::-1]])
    planes = np.array(jax_raisr.upscale_planes(jnp.asarray(x), case["jcfg"],
                                               h2p, w2p, hq, wq, hp))
    got = port_raisr.hash_planes(torch.from_numpy(planes), case["cfg"], hp, h2p, w2p)
    _agree(got, jax_raisr.hash_planes(jnp.asarray(planes), case["jcfg"], hp, h2p, w2p))
    # one image without a batch dim
    one = port_raisr.hash_planes(torch.from_numpy(planes[0]), case["cfg"], hp, h2p, w2p)
    assert torch.equal(one, got[0])
