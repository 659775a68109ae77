"""PyTorch port: the Gaussian pyramid on the CPU against the JAX package
(equal for uint8 input: every product and sum is exact in float32) and the
numpy oracle (within one level)."""

import numpy as np
import pytest
import torch

from oclcomputervision_tpu import oracle
from oclcomputervision_tpu.ops import pyramid as jax_pyramid
from oclcomputervision_tpu_torch import ops

torch.set_num_threads(2)

CASES = {
    "2d_odd": ((37, 53), None),
    "2d_even": ((64, 48), None),
    "batched": ((3, 40, 56), True),
    "channels": ((33, 47, 3), None),
    "batched_channels": ((2, 24, 32, 3), None),
}


def _image(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("case", list(CASES))
def test_pyr_down_equals_jax(case):
    shape, batched = CASES[case]
    img = _image(shape)
    got = ops.pyr_down(img, 2, batched=batched, device="cpu")
    want = np.asarray(jax_pyramid.pyr_down(img, 2, batched=batched))
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(37, 53), (33, 47, 3)])
def test_pyr_down_within_one_level_of_the_numpy_oracle(shape):
    img = _image(shape, 1)
    got = ops.pyr_down(img, device="cpu").numpy().astype(int)
    assert np.abs(got - oracle.pyr_down(img).astype(int)).max() <= 1


@pytest.mark.parametrize("scale", [3, 4])
def test_pyr_down_other_scales_equal_jax(scale):
    img = _image((50, 61), scale)
    got = ops.pyr_down(img, scale, device="cpu")
    want = np.asarray(jax_pyramid.pyr_down(img, scale))
    np.testing.assert_array_equal(got.numpy(), want)
    assert tuple(got.shape) == (50 // scale, 61 // scale)


def test_pyr_down_float_input_matches_jax():
    img = np.random.default_rng(2).uniform(0, 255, (31, 42)).astype(np.float32)
    got = ops.pyr_down(img, device="cpu")
    assert got.dtype == torch.float32
    # float products round: XLA:CPU may contract them into fused multiply-adds
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_pyramid.pyr_down(img)), rtol=1e-6)


@pytest.mark.parametrize("case", ["2d_odd", "batched", "channels"])
def test_gaussian_pyramid_equals_jax(case):
    shape, batched = CASES[case]
    img = _image(shape, 3)
    got = ops.gaussian_pyramid(img, 2, 3, batched=batched, device="cpu")
    want = jax_pyramid.gaussian_pyramid(img, 2, 3, batched=batched)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert [tuple(g.shape) for g in got] == [np.asarray(w).shape for w in want]


def test_gaussian_pyramid_on_the_middlebury_frame(frames_gray):
    g0, _ = frames_gray
    got = ops.gaussian_pyramid(g0, 2, 3, device="cpu")
    want = jax_pyramid.gaussian_pyramid(g0, 2, 3)
    ref = oracle.gaussian_pyramid(g0, 2, 3)
    assert [tuple(g.shape) for g in got] == [(120, 160), (240, 320), (480, 640)]
    for g, w, r in zip(got, want, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert np.abs(g.numpy().astype(int) - r.astype(int)).max() <= 1


def test_rank3_layout_rules():
    stack = _image((5, 40, 56))
    with pytest.raises(ValueError, match="ambiguous"):
        ops.pyr_down(stack, device="cpu")
    with pytest.raises(ValueError, match="ambiguous"):
        ops.gaussian_pyramid(stack, device="cpu")
    assert tuple(ops.pyr_down(stack, batched=True, device="cpu").shape) == (5, 20, 28)
    # a tensor stays where it is
    assert ops.pyr_down(torch.from_numpy(stack), batched=True).device.type == "cpu"


def test_numpy_input_needs_the_card_by_default():
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        ops.pyr_down(_image((16, 16)))
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        ops.gaussian_pyramid(_image((16, 16)))
