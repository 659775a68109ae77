"""PyTorch port: global histogram equalization on the CPU, against the JAX
package (the Pallas kernels in interpret mode and the XLA twins) and the
numpy oracle. The CUDA kernels themselves are held against these plain
versions on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oclcomputervision_tpu import oracle
from oclcomputervision_tpu.ops import histeq as jax_histeq
from oclcomputervision_tpu.ops.pallas.histeq_pallas import (
    TILE_P,
    apply_lut_pallas,
    hist256_pallas,
    histeq_global_pallas,
)
from oclcomputervision_tpu_torch import ops
from oclcomputervision_tpu_torch.kernels import _build
from oclcomputervision_tpu_torch.kernels import histeq as khisteq

torch.set_num_threads(2)

TRANSFER_PARAMS = [(1.0, 0.05, 2.0), (0.5, 0.05, 3.0), (0.8, 0.01, 10.0)]


@pytest.fixture(scope="module")
def ue(under_exposure_gray):
    return np.ascontiguousarray(under_exposure_gray[:512, :1024])  # 512*1024 % TILE_P == 0


def _global_inputs(name, ue):
    rng = np.random.default_rng(11)
    if name == "under_exposure":
        return ue
    if name == "batch":
        return np.stack([ue[:64, :1024], ue[::-1][:64, :1024].copy()])
    return rng.integers(0, 256, size=(100, 100), dtype=np.uint8)  # unaligned


def test_hist256_matches_pallas_kernel_and_xla():
    x = np.random.default_rng(1).integers(0, 256, size=(3, 2 * TILE_P), dtype=np.uint8)
    got = khisteq.hist256_kernel(torch.from_numpy(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 256)
    np.testing.assert_array_equal(got.numpy(), np.asarray(hist256_pallas(x, interpret=True)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_histeq.histogram256(x)))


def test_histogram256_any_length_matches_xla():
    # no tile padding in the port: any N, leading dims kept
    x = np.random.default_rng(2).integers(0, 256, size=(2, 3, 1001), dtype=np.uint8)
    got = ops.histogram256(x, device="cpu")
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 3, 256)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_histeq.histogram256(x)))


def test_apply_lut_matches_pallas_kernel():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 256, size=(2, TILE_P), dtype=np.uint8)
    luts = rng.integers(0, 256, size=(2, 256), dtype=np.uint8)
    got = khisteq.apply_lut_kernel(torch.from_numpy(x), torch.from_numpy(luts))
    np.testing.assert_array_equal(got.numpy(), np.asarray(apply_lut_pallas(x, luts, interpret=True)))


def test_apply_lut_op_matches_xla(lenna_gray):
    lut = np.random.default_rng(4).integers(0, 256, size=256, dtype=np.uint8)
    img = lenna_gray[:77, :131]
    got = ops.apply_lut(img, lut, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_histeq.apply_lut(img, lut)))
    with pytest.raises(TypeError):
        ops.apply_lut(img, lut.astype(np.float32), device="cpu")


@pytest.mark.parametrize("alpha,punch,clip", TRANSFER_PARAMS)
def test_calc_transfer_func_matches_jax(ue, alpha, punch, clip):
    hists = np.stack([np.bincount(r.reshape(-1), minlength=256) for r in (ue, ue[:200], ue[300:])])
    want = np.asarray(jax_histeq.calc_transfer_func(hists, alpha, punch, clip))
    got = ops.calc_transfer_func(torch.from_numpy(hists), alpha, punch, clip).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    if alpha == 1.0:
        # (1 - alpha) * idx vanishes, so XLA's fused multiply-adds change nothing
        np.testing.assert_array_equal(got.astype(np.uint8), want.astype(np.uint8))
    assert np.abs(got - want).max() <= 1e-4


@pytest.mark.parametrize("clip_limit", [1.5, 2.5])
def test_clip_histogram_matches_jax(ue, clip_limit):
    hists = np.stack([np.bincount(r.reshape(-1), minlength=256) for r in (ue[:128], ue[128:256])])
    want = np.asarray(jax_histeq.clip_histogram(hists, clip_limit))
    got = ops.clip_histogram(torch.from_numpy(hists), clip_limit).numpy()
    assert np.abs(got - want).max() <= 1e-3  # counts up to ~6e4: a few f32 ULPs


@pytest.mark.parametrize("name", ["under_exposure", "batch", "unaligned"])
def test_histeq_global_matches_pallas_and_xla_twin(ue, name):
    img = _global_inputs(name, ue)
    got = ops.histeq_global(img, device="cpu")
    assert got.dtype == torch.uint8 and tuple(got.shape) == img.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(histeq_global_pallas(img, interpret=True)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_histeq.histeq_global(img)))


def test_histeq_global_matches_oracle_off_defaults(under_exposure_gray):
    # tests/test_histeq.py's bound: fp32-vs-fp64 LUT rounding only
    want = oracle.histeq_global(under_exposure_gray, 0.5, 0.02, 4.0)
    got = ops.histeq_global(under_exposure_gray, 0.5, 0.02, 4.0, device="cpu").numpy()
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01


def test_hist_grid_matches_xla(lenna_gray):
    got = ops.hist_grid(lenna_gray, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_histeq.hist_grid(lenna_gray)))
    with pytest.raises(ValueError, match="not divisible"):
        ops.hist_grid(lenna_gray[:100], device="cpu")


@pytest.mark.parametrize("op", ["histeq_global", "histeq_local_block"])
def test_rank3_channels_last_guard_matches_jax(lenna_rgb, op):
    img = lenna_rgb[:256, :256]
    with pytest.raises(ValueError) as want:
        getattr(jax_histeq, op)(img)
    with pytest.raises(ValueError) as got:
        getattr(ops, op)(img, device="cpu")
    assert str(got.value) == str(want.value)


def test_numpy_input_runs_on_the_card_unless_cpu_is_asked(ue):
    # no card here: the default device raises instead of falling back
    with pytest.raises(RuntimeError, match="cuda"):
        ops.histeq_global(ue)
    with pytest.raises(RuntimeError, match="cuda"):
        ops.histeq_local_block(ue)
    got = ops.histeq_global(ue, device="cpu")
    assert got.device.type == "cpu"
    # a tensor runs on its own device
    assert torch.equal(ops.histeq_global(torch.from_numpy(ue)), got)


def test_wrappers_take_the_plain_path_for_cpu_tensors():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.integers(0, 256, size=(2, 999), dtype=np.uint8))
    luts = torch.from_numpy(rng.integers(0, 256, size=(2, 256), dtype=np.uint8))
    _build.reset_launches()
    assert torch.equal(khisteq.hist256_kernel(x), khisteq.hist256(x))
    assert torch.equal(khisteq.apply_lut_kernel(x, luts), khisteq.apply_lut(x, luts))
    assert set(_build.LAUNCHES.values()) == {0}
    meta = torch.empty((2, 999), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        khisteq.hist256_kernel(meta)
    with pytest.raises(ValueError, match="CUDA tensor"):
        khisteq.apply_lut_kernel(meta, luts)
