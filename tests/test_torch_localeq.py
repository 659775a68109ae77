"""PyTorch port: local-block (CLAHE-style) histogram equalization on the CPU,
against the JAX package (the Pallas kernels in interpret mode and the XLA
twin) and the numpy oracle. The CUDA kernels themselves are held against
these plain versions on the card by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oclcomputervision_tpu import oracle
from oclcomputervision_tpu.ops import histeq as jax_histeq
from oclcomputervision_tpu.ops.pallas.localeq_pallas import (
    hist_tiles_pallas,
    histeq_local_fused_pallas,
)
from oclcomputervision_tpu_torch import ops
from oclcomputervision_tpu_torch.kernels import _build
from oclcomputervision_tpu_torch.kernels import localeq as klocaleq

torch.set_num_threads(2)

BS = (256, 256)


@pytest.fixture(scope="module")
def ue(under_exposure_gray):
    return np.ascontiguousarray(under_exposure_gray[:512, :1024])


def _within_one(got, want, share):
    d = np.abs(np.asarray(got).astype(int) - np.asarray(want).astype(int))
    assert d.max() <= 1 and (d > 0).mean() < share, (d.max(), (d > 0).mean())


def test_hist_tiles_matches_pallas_quadrants(ue):
    g3 = np.stack([ue, ue[::-1].copy()])
    got = klocaleq.hist_tiles_kernel(torch.from_numpy(g3), BS)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 2, 4, 256)
    quads = np.asarray(hist_tiles_pallas(jnp.asarray(g3), 128, 128, interpret=True))
    want = quads.reshape(2, 2, 2, 4, 2, 256).sum(axis=(2, 4))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("tile", [(32, 256), (101, 7), (8, 16)])
def test_hist_tiles_any_dividing_tile_matches_xla_hist_grid(lenna_gray, tile):
    th, tw = tile
    img = np.ascontiguousarray(lenna_gray[: 512 // th * th, : 512 // tw * tw])
    got = klocaleq.hist_tiles(torch.from_numpy(img)[None], tile)[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_histeq.hist_grid(img, tile)))


@pytest.mark.parametrize("clahe", [0.0, 2.0])
def test_block_mappings_match_jax(ue, clahe):
    want = np.asarray(jax_histeq.block_mappings(ue, 0.5, 0.05, 3.0, BS, clahe))
    got = ops.block_mappings(ue, 0.5, 0.05, 3.0, BS, clahe, device="cpu").numpy()
    assert got.shape == want.shape == (2, 4, 256)
    assert np.abs(got - want).max() <= 1e-4


@pytest.mark.parametrize("rows,cols", [(512, 1024), (551, 1024), (600, 1100)])
def test_apply_block_mappings_matches_xla_twin(under_exposure_gray, ue, rows, cols):
    # JAX's mappings carried across as numpy; (551, 1024) and (600, 1100)
    # are geometries the blocks do not divide (the TPU's _blend_tiles job)
    m = np.asarray(jax_histeq.block_mappings(ue, 0.5, 0.05, 3.0, BS))
    img = np.ascontiguousarray(np.tile(under_exposure_gray, (2, 2))[:rows, :cols])
    want = np.asarray(jax_histeq.apply_block_mappings(img, m, BS))
    got = ops.apply_block_mappings(img, m, BS, device="cpu")
    assert got.dtype == torch.uint8 and tuple(got.shape) == (rows, cols)
    _within_one(got.numpy(), want, 0.001)


@pytest.mark.parametrize("clahe", [0.0, 2.0])
def test_histeq_local_block_matches_xla_twin(ue, clahe):
    want = np.asarray(jax_histeq.histeq_local_block(ue, 0.5, 0.05, 3.0, BS, clahe))
    got = ops.histeq_local_block(ue, 0.5, 0.05, 3.0, BS, clahe, device="cpu").numpy()
    _within_one(got, want, 0.001)


@pytest.mark.parametrize("clahe", [0.0, 2.0])
def test_histeq_local_block_matches_fused_pallas(ue, clahe):
    # the TPU blend splits each LUT into int8 integer and fraction parts
    want = np.asarray(
        histeq_local_fused_pallas(jnp.asarray(ue)[None], 0.5, 0.05, 3.0, BS, clahe, interpret=True)
    )[0]
    got = ops.histeq_local_block(ue, 0.5, 0.05, 3.0, BS, clahe, device="cpu").numpy()
    _within_one(got, want, 0.002)


def test_histeq_local_block_general_blockshape_matches_oracle(lenna_gray):
    want = oracle.histeq_local_block(lenna_gray.copy(), blockshape=(128, 64))
    got = ops.histeq_local_block(lenna_gray, blockshape=(128, 64), device="cpu").numpy()
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_batched_equals_single(ue):
    batch = np.stack([ue, ue[::-1].copy()])
    got = ops.histeq_local_block(batch, clahe_clip=2.0, device="cpu")
    for i in range(2):
        assert torch.equal(got[i], ops.histeq_local_block(batch[i], clahe_clip=2.0, device="cpu"))


@pytest.mark.parametrize("y0,rows", [(0, 200), (77, 300), (384, 256), (-128, 200)])
def test_blend_band_equals_the_whole_images_rows(ue, y0, rows):
    # a band from image row y0 (the row-sharded local histeq's blend) gives
    # the whole image's rows; y0 = -bh/2 starts at the padded grid's top
    m4 = torch.from_numpy(
        np.random.default_rng(7).uniform(-20, 280, size=(1, 2, 4, 256)).astype(np.float32)
    )
    g3 = torch.from_numpy(ue)[None]
    whole = klocaleq.blend_blocks(g3, m4, BS)
    lo, hi = max(0, y0), min(ue.shape[0], y0 + rows)
    band = torch.zeros((1, rows, ue.shape[1]), dtype=torch.uint8)
    band[0, lo - y0 : hi - y0] = g3[0, lo:hi]
    got = klocaleq.blend_blocks_kernel(band, m4, BS, y0)
    assert torch.equal(got[0, lo - y0 : hi - y0], whole[0, lo:hi])


def test_geometry_limits(ue):
    with pytest.raises(ValueError, match="not divisible"):
        ops.histeq_local_block(ue[:500], device="cpu")
    m = np.zeros((2, 4, 256), np.float32)
    # the padded grid holds at most (2 + 1) * 256 - 128 = 640 rows
    ops.apply_block_mappings(np.zeros((640, 1024), np.uint8), m, BS, device="cpu")
    with pytest.raises(ValueError, match="exceeds"):
        ops.apply_block_mappings(np.zeros((641, 1024), np.uint8), m, BS, device="cpu")
    g3, m4 = torch.zeros((1, 128, 1024), dtype=torch.uint8), torch.from_numpy(m)[None]
    klocaleq.blend_blocks(g3, m4, BS, 512)  # rows 512-639
    with pytest.raises(ValueError, match="exceeds"):
        klocaleq.blend_blocks(g3, m4, BS, 513)
    with pytest.raises(ValueError, match="above the padded grid"):
        klocaleq.blend_blocks(g3, m4, BS, -129)


def test_wrappers_take_the_plain_path_for_cpu_tensors(ue):
    g3 = torch.from_numpy(ue)[None]
    m4 = torch.from_numpy(
        np.random.default_rng(6).uniform(-20, 280, size=(1, 2, 4, 256)).astype(np.float32)
    )
    _build.reset_launches()
    assert torch.equal(klocaleq.hist_tiles_kernel(g3, BS), klocaleq.hist_tiles(g3, BS))
    assert torch.equal(klocaleq.blend_blocks_kernel(g3, m4, BS), klocaleq.blend_blocks(g3, m4, BS))
    assert set(_build.LAUNCHES.values()) == {0}
    meta = torch.empty((1, 512, 1024), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        klocaleq.hist_tiles_kernel(meta, BS)
    with pytest.raises(ValueError, match="CUDA tensor"):
        klocaleq.blend_blocks_kernel(meta, m4, BS)
