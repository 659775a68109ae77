"""PyTorch port: the align-corners bilinear/bicubic resize on the CPU, against
the JAX package's ``ops.interpolation`` and the numpy oracle. No kernel
stands behind it; these torch ops run as they are on the card."""

import jax
import numpy as np
import pytest
import torch

from oclcomputervision_tpu.ops import interpolation as jax_interp
from oclcomputervision_tpu_torch import ops
from oclcomputervision_tpu_torch.ops import interpolation as port_interp
from oclcomputervision_tpu_torch.oracle import interpolation as port_oracle

torch.set_num_threads(2)

# XLA:CPU may contract a multiply-add into an FMA, the port rounds both
# steps: one f32 ULP apart can round to the other uint8 level
FLOAT_TOL = 1e-4  # on the [0, 255] scale
LAYOUTS = {
    "gray": ((19, 23), None),
    "rgb": ((19, 23, 3), None),
    "luma_stack": ((3, 19, 23), True),
    "bhwc": ((2, 19, 23, 4), None),
}
SIZES = {"up": (41, 50), "down": (11, 9)}


@pytest.fixture(scope="module", autouse=True)
def _drop_jax_programs():
    yield
    jax.clear_caches()


def _image(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _per_image(img, batched):
    """The [H, W] or [H, W, C] images of a layout, for the numpy oracle."""
    if img.ndim == 2 or (img.ndim == 3 and not batched):
        return [img], lambda outs: outs[0]
    return list(img), np.stack


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("mapping", ["align_corners", "hw_sampler", "half_pixel"])
@pytest.mark.parametrize("method", ["bilinear", "bicubic"])
def test_resize_matches_jax_and_oracle(method, mapping, layout, size):
    shape, batched = LAYOUTS[layout]
    img = _image(shape)
    out_hw = SIZES[size]
    got_f = ops.resize(img, out_hw, method, mapping, batched=batched, device="cpu")
    want_f = np.asarray(jax_interp.resize(img, out_hw, method, mapping, batched=batched))
    assert got_f.dtype == torch.float32 and tuple(got_f.shape) == want_f.shape
    np.testing.assert_allclose(got_f.numpy(), want_f, rtol=0, atol=FLOAT_TOL)

    got = ops.resize_uint8(img, out_hw, method, mapping, batched=batched, device="cpu")
    want = np.asarray(jax_interp.resize_uint8(img, out_hw, method, mapping, batched=batched))
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    assert np.abs(got.numpy().astype(int) - want.astype(int)).max() <= 1

    images, pack = _per_image(img, batched)
    oracle = pack([port_oracle.resize_uint8(x, out_hw, method, mapping) for x in images])
    assert np.abs(got.numpy().astype(int) - oracle.astype(int)).max() <= 1


@pytest.mark.parametrize("mapping", ["align_corners", "half_pixel"])
@pytest.mark.parametrize("method", ["bilinear", "bicubic"])
def test_float_input_and_bicubic_clamp(method, mapping):
    # float input keeps its [0, 1] range: bicubic overshoot clamps to 1.0
    img = np.zeros((12, 12), np.float32)
    img[:, 6:] = 1.0
    img[3, 3] = 1.0
    got = ops.resize(img, (31, 29), method, mapping, device="cpu").numpy()
    want = np.asarray(jax_interp.resize(img, (31, 29), method, mapping))
    np.testing.assert_allclose(got, want, rtol=0, atol=FLOAT_TOL / 255)
    assert got.min() >= 0.0 and got.max() <= 1.0
    oracle = port_oracle.resize_align_corners(img, (31, 29), method, mapping=mapping)
    np.testing.assert_allclose(got, oracle, rtol=0, atol=FLOAT_TOL / 255)


@pytest.mark.parametrize("name", ["bilinear", "bilinear_lds", "bicubic"])
def test_reference_named_aliases_match_jax(name, lenna_gray):
    src = np.ascontiguousarray(lenna_gray[100:140, 200:256])
    got = getattr(port_interp, name)(src, (80, 112), device="cpu").numpy()
    want = np.asarray(getattr(jax_interp, name)(src, (80, 112)))
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    # the bilinear alias is the HW-sampler convention, the lds one align-corners
    mapping = "hw_sampler" if name == "bilinear" else "align_corners"
    method = "bicubic" if name == "bicubic" else "bilinear"
    oracle = port_oracle.resize_uint8(src, (80, 112), method, mapping)
    assert np.abs(got.astype(int) - oracle.astype(int)).max() <= 1


def test_identity_size_is_exact(lenna_rgb):
    src = np.ascontiguousarray(lenna_rgb[:32, :48])
    for method in ("bilinear", "bicubic"):
        got = ops.resize_uint8(src, (32, 48), method, device="cpu")
        np.testing.assert_array_equal(got.numpy(), src)


def test_rank_layout_errors():
    img = _image((5, 20, 16))
    with pytest.raises(ValueError, match="ambiguous"):
        ops.resize(img, (10, 8), device="cpu")
    with pytest.raises(ValueError, match="ambiguous"):
        jax_interp.resize(img, (10, 8))
    # the explicit layouts both work and differ in shape
    assert tuple(ops.resize(img, (10, 8), batched=True, device="cpu").shape) == (5, 10, 8)
    assert tuple(ops.resize(img, (10, 8), batched=False, device="cpu").shape) == (10, 8, 16)
    with pytest.raises(ValueError, match="rank"):
        ops.resize(_image((1, 2, 5, 6, 3)), (10, 8), device="cpu")
    with pytest.raises(ValueError, match="method"):
        ops.resize(_image((6, 6)), (10, 8), "nearest", device="cpu")
    with pytest.raises(ValueError, match="mapping"):
        ops.resize(_image((6, 6)), (10, 8), mapping="corner", device="cpu")


def test_runs_on_the_card_unless_cpu_is_asked():
    img = _image((8, 8))
    with pytest.raises(RuntimeError, match="cuda"):
        ops.resize_uint8(img, (16, 16))
    # a tensor runs on its own device
    got = ops.resize_uint8(torch.from_numpy(img), (16, 16))
    assert got.device.type == "cpu"
    assert torch.equal(got, ops.resize_uint8(img, (16, 16), device="cpu"))
