"""PyTorch port: the torch-op steps around the motion searches (median
filter, seed upscale, subpixel refinement) and the coarse-to-fine pyramid as
a whole, on the CPU against the JAX package. Integer flows are equal; where
products round (the 'shipped' seed normalisation, subpixel offsets) XLA:CPU
may contract them into fused multiply-adds, so those are held to a
tolerance."""

import jax
import numpy as np
import pytest
import torch

from oclcomputervision_tpu.ops import motion as jax_motion
from oclcomputervision_tpu.utils import epe
from oclcomputervision_tpu_torch import ops
from oclcomputervision_tpu_torch.ops import motion as port_motion
from oclcomputervision_tpu_torch.utils import config
from oclcomputervision_tpu_torch.utils import epe as port_epe

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def cut_pair(frames_gray):
    """The Middlebury pair cut to 96 x 128."""
    g0, g1 = frames_gray
    return np.ascontiguousarray(g0[::5, ::5]), np.ascontiguousarray(g1[::5, ::5])


@pytest.fixture(scope="module", autouse=True)
def _drop_jax_programs():
    yield
    jax.clear_caches()


def _int_flow(shape, amp=12, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(-amp, amp + 1, (*shape, 2)).astype(np.float32)


@pytest.mark.parametrize("k", [3, 5, 9])
def test_median_filter_flow_equals_jax(k):
    mv = _int_flow((2, 30, 44)) + np.random.default_rng(k).uniform(-0.5, 0.5, (2, 30, 44, 2)).astype(np.float32)
    want = np.asarray(jax_motion.median_filter_flow(mv, k))
    np.testing.assert_array_equal(ops.median_filter_flow(mv, k, device="cpu").numpy(), want)
    np.testing.assert_array_equal(ops.median_filter_flow(mv[0], k, device="cpu").numpy(), want[0])


def test_median_filter_flow_rejects_even_kernels():
    with pytest.raises(ValueError, match="odd"):
        ops.median_filter_flow(_int_flow((8, 8)), 4, device="cpu")


def test_upscale_mv_fixed_on_integer_flows_equals_jax():
    mv = _int_flow((2, 24, 32), seed=1)
    for m in (mv, mv[0]):
        want = np.asarray(jax_motion.upscale_mv(m, 2, mode="fixed"))
        got = ops.upscale_mv(m, 2, mode="fixed", device="cpu").numpy()
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["shipped", "fixed"])
def test_upscale_mv_fractional_flows_match_jax(mode):
    rng = np.random.default_rng(2)
    mv = rng.uniform(-9, 9, (2, 24, 32, 2)).astype(np.float32)
    want = np.asarray(jax_motion.upscale_mv(mv, 2, mode=mode))
    got = ops.upscale_mv(mv, 2, mode=mode, device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        ops.upscale_mv(mv, 2, mode="other", device="cpu")


def test_resize_bilinear_halfpixel_matches_jax():
    a = np.random.default_rng(3).standard_normal((24, 30)).astype(np.float32)
    want = np.asarray(jax_motion.resize_bilinear_halfpixel(a, (48, 75)))
    got = ops.resize_bilinear_halfpixel(a, (48, 75), device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("costfn", ["sad", "ssd"])
def test_refine_flow_subpixel_matches_jax(cut_pair, costfn):
    f0, f1 = (a[:48, :64] for a in cut_pair)
    # half-integer flows too: both sides round them half to even
    flow = _int_flow((48, 64), 4, seed=4) + np.random.default_rng(5).choice(
        [0.0, 0.5, 0.25], (48, 64, 2)).astype(np.float32)
    want = np.asarray(jax_motion.refine_flow_subpixel(f0, f1, flow, 5, costfn))
    got = ops.refine_flow_subpixel(f0, f1, flow, 5, costfn, device="cpu").numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    b = ops.refine_flow_subpixel(
        np.stack([f0, f1]), np.stack([f1, f0]), np.stack([flow, flow]), 5, costfn, device="cpu")
    np.testing.assert_array_equal(b[0].numpy(), got)
    with pytest.raises(ValueError, match="sad/ssd"):
        ops.refine_flow_subpixel(f0, f1, flow, 5, "wsad", device="cpu")


def test_bounds_and_halos():
    assert ops.exact_flow_bound(3) == 56  # (2**3 - 1) * (5 + 2 + 1)
    assert ops.exact_flow_bound(3, 11, 5) == 7 * 4
    assert jax_motion.exact_flow_bound(3) == 49  # one short of what the steps reach
    for geometry in ((15, 5), (9, 3), (11, 5)):
        assert port_motion.exact_halo_rows(*geometry) == jax_motion.exact_halo_rows(*geometry)
        assert port_motion.fast_halo_rows(*geometry) == jax_motion.fast_halo_rows(*geometry)


def test_motion_config_crosses_by_its_fields():
    import dataclasses

    from oclcomputervision_tpu.utils.config import MotionConfig as JaxMotionConfig

    cfg = config.MotionConfig(**dataclasses.asdict(JaxMotionConfig(search_size=9, patch_size=3)))
    assert (cfg.search_size, cfg.patch_size, cfg.levels) == (9, 3, 3)


def _levels(flows):
    return [np.asarray(f) if not isinstance(f, torch.Tensor) else f.numpy() for f in flows]


def test_exact_pyramid_equals_jax_at_every_level(cut_pair, flow_gt):
    f0, f1 = cut_pair
    want = _levels(jax_motion.estimate_motion_pyramid(f0, f1, 3, method="exact", smooth=5))
    got = _levels(ops.estimate_motion_pyramid(f0, f1, 3, method="exact", smooth=5, device="cpu"))
    assert [g.shape for g in got] == [(24, 32, 2), (48, 64, 2), (96, 128, 2)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (got[-1] == np.round(got[-1])).all()
    assert np.abs(got[-1]).max() <= ops.exact_flow_bound(3)
    # the cut frames move a fifth as far as the full ones
    gt = flow_gt[::5, ::5] / 5
    assert port_epe(got[-1], gt) == epe(want[-1], gt) < epe(np.zeros_like(gt), gt)


def test_hybrid_pyramid_equals_jax_at_every_level(cut_pair):
    f0, f1 = cut_pair
    # warp_bound=64 is the residual form on both sides while no seed passes 64 px
    kw = {"method": "fast", "smooth": 5, "warp_bound": 64}
    want = _levels(jax_motion.estimate_motion_pyramid(f0, f1, 3, **kw))
    got = _levels(ops.estimate_motion_pyramid(f0, f1, 3, device="cpu", **kw))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # the port's 'auto' is that residual form
    auto = _levels(ops.estimate_motion_pyramid(f0, f1, 3, method="fast", smooth=5, device="cpu"))
    for g, a in zip(got, auto):
        np.testing.assert_array_equal(g, a)


@pytest.mark.parametrize("method", ["exact", "fast"])
def test_subpixel_pyramid_matches_jax(cut_pair, method):
    f0, f1 = cut_pair
    kw = {"method": method, "smooth": 5, "warp_bound": 64, "subpixel": 2}
    want = _levels(jax_motion.estimate_motion_pyramid(f0, f1, 3, **kw))
    got = _levels(ops.estimate_motion_pyramid(f0, f1, 3, device="cpu", **kw))
    close = (np.abs(got[-1] - want[-1]) <= 1e-4).all(axis=-1).mean()
    assert close >= 0.995, close
    assert epe(got[-1], want[-1]) < 0.01
    assert not (got[-1] == np.round(got[-1])).all()


def test_shipped_seed_mode_pyramid_matches_jax(cut_pair):
    f0, f1 = cut_pair
    with pytest.warns(RuntimeWarning, match="saturates"):
        want = _levels(jax_motion.estimate_motion_pyramid(f0, f1, 3, seed_mode="shipped"))
    with pytest.warns(RuntimeWarning, match="saturates"):
        got = _levels(ops.estimate_motion_pyramid(f0, f1, 3, seed_mode="shipped", device="cpu"))
    np.testing.assert_array_equal(got[0], want[0])
    # u / u_max * (u_max * 2) rounds; a seed within one ULP of an integer can
    # truncate differently and move a few vectors
    for g, w in zip(got[1:], want[1:]):
        assert (np.abs(g - w) <= 1e-4).all(axis=-1).mean() >= 0.995


def test_single_level_fast_stays_pure_fast(cut_pair):
    f0, f1 = cut_pair
    got = ops.estimate_motion_pyramid(f0, f1, 1, method="fast", device="cpu")
    assert len(got) == 1
    want = ops.estimate_motion_vector(f0, f1, method="fast", device="cpu")
    assert torch.equal(got[0], want)


@pytest.mark.parametrize("method", ["exact", "fast"])
def test_batched_pyramid_equals_per_pair(cut_pair, method):
    f0, f1 = cut_pair
    b0, b1 = np.stack([f0, f1]), np.stack([f1, f0])
    got = ops.estimate_motion_pyramid(b0, b1, 3, method=method, smooth=5, device="cpu")
    assert [tuple(g.shape) for g in got] == [(2, 24, 32, 2), (2, 48, 64, 2), (2, 96, 128, 2)]
    for n in range(2):
        one = ops.estimate_motion_pyramid(b0[n], b1[n], 3, method=method, smooth=5, device="cpu")
        for g, o in zip(got, one):
            assert torch.equal(g[n], o)


def test_refine_modes(cut_pair):
    f0, f1 = cut_pair
    with pytest.raises(ValueError, match="refine"):
        ops.estimate_motion_pyramid(f0, f1, 2, refine="sometimes", device="cpu")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        ops.estimate_motion_pyramid(f0, f1, 2)
    # refine='none' is the pure fast pyramid, 'exact' refines the exact one too
    kw = {"method": "fast", "smooth": 5, "warp_bound": 64}
    pure = ops.estimate_motion_pyramid(f0, f1, 2, refine="none", device="cpu", **kw)
    want = jax_motion.estimate_motion_pyramid(f0, f1, 2, refine="none", **kw)
    for g, w in zip(pure, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    hybrid = ops.estimate_motion_pyramid(f0, f1, 2, device="cpu", **kw)
    assert not torch.equal(pure[-1], hybrid[-1])
