"""PyTorch port: the exact and the fast block-matching search of one level on
the CPU, against the numpy oracle and the JAX package (its XLA searches, and
each Pallas kernel once in interpret mode). The searches are integer, so the
results are equal; the float WSAD costs are held as tests/test_motion.py
holds JAX's. The CUDA kernels themselves are held against these plain
versions on the card by chip_smoke.py."""

import jax
import numpy as np
import pytest
import torch

from oclcomputervision_tpu.ops import motion as jax_motion
from oclcomputervision_tpu.ops.pallas.me_pallas import me_exact_pallas, me_exact_pallas_seeded
from oclcomputervision_tpu.oracle import motion as onp
from oclcomputervision_tpu_torch import ops
from oclcomputervision_tpu_torch.kernels import _build
from oclcomputervision_tpu_torch.kernels import motion as kmotion

torch.set_num_threads(2)

H, W = 24, 40  # one shape for every JAX program here: each new one compiles


@pytest.fixture(scope="module")
def pair(frames_gray):
    g0, g1 = frames_gray
    return (np.ascontiguousarray(g0[100 : 100 + H, 200 : 200 + W]),
            np.ascontiguousarray(g1[100 : 100 + H, 200 : 200 + W]))


@pytest.fixture(scope="module", autouse=True)
def _drop_jax_programs():
    yield
    jax.clear_caches()


def _seed(amp, shape=(H, W), seed=0):
    return np.random.default_rng(seed).uniform(-amp, amp, (*shape, 2)).astype(np.float32)


def _port(f0, f1, *args, **kw):
    return ops.estimate_motion_vector(f0, f1, *args, device="cpu", **kw).numpy()


@pytest.mark.parametrize("costfn", ["sad", "ssd"])
@pytest.mark.parametrize("geometry", [(15, 5), (9, 3), (11, 5)])
def test_exact_unseeded_equals_oracle_and_jax(pair, geometry, costfn):
    f0, f1 = pair
    got = _port(f0, f1, *geometry, costfn=costfn)
    assert got.dtype == np.float32 and got.shape == (H, W, 2)
    np.testing.assert_array_equal(got, onp.estimate_motion_vector(f0, f1, *geometry, costfn=costfn))
    if geometry != (15, 5) or costfn == "sad":  # the 15/5 S-map program compiles for 10 s
        want = jax_motion.estimate_motion_vector(f0, f1, *geometry, costfn=costfn)
        np.testing.assert_array_equal(got, np.asarray(want))


def test_exact_batched_equals_per_pair_and_jax(pair):
    f0, f1 = pair
    b0, b1 = np.stack([f0, f1, f0[::-1]]), np.stack([f1, f0, f1[::-1]])
    got = _port(b0, b1, 9, 3)
    assert got.shape == (3, H, W, 2)
    for n in range(3):
        np.testing.assert_array_equal(got[n], onp.estimate_motion_vector(b0[n], b1[n], 9, 3))
    np.testing.assert_array_equal(
        got, np.asarray(jax_motion.estimate_motion_vector(b0, b1, 9, 3)))


@pytest.mark.parametrize("seed_bound", [8, "auto", "none"])
@pytest.mark.parametrize("seed_mode", ["shipped", "fixed"])
def test_exact_seeded_equals_oracle_and_jax(pair, seed_mode, seed_bound):
    f0, f1 = pair
    sd = _seed(6)  # |trunc(seed)| <= 5: inside every bound
    got = _port(f0, f1, 15, 5, seed=sd, seed_mode=seed_mode, seed_bound=seed_bound)
    want = onp.estimate_motion_vector(f0, f1, 15, 5, seed=sd, seed_mode=seed_mode)
    np.testing.assert_array_equal(got, want)
    ref = jax_motion.estimate_motion_vector(
        f0, f1, 15, 5, seed=sd, seed_mode=seed_mode, seed_bound=seed_bound)
    np.testing.assert_array_equal(got, np.asarray(ref))


@pytest.mark.parametrize("geometry, costfn", [((9, 3), "sad"), ((11, 5), "ssd")])
def test_exact_seeded_other_geometries_equal_oracle(pair, geometry, costfn):
    f0, f1 = pair
    b0, b1, sd = np.stack([f0, f1]), np.stack([f1, f0]), _seed(11, (2, H, W), 1)
    got = _port(b0, b1, *geometry, seed=sd, seed_mode="fixed", costfn=costfn)
    for n in range(2):
        want = onp.estimate_motion_vector(
            b0[n], b1[n], *geometry, seed=sd[n], seed_mode="fixed", costfn=costfn)
        np.testing.assert_array_equal(got[n], want)


@pytest.mark.parametrize("seed_mode", ["shipped", "fixed"])
def test_a_seed_beyond_the_bound_saturates_with_a_warning(pair, seed_mode):
    f0, f1 = pair
    sd = _seed(20, seed=2)
    with pytest.warns(RuntimeWarning, match="saturates"):
        got = _port(f0, f1, 15, 5, seed=sd, seed_mode=seed_mode, seed_bound=8)
    with pytest.warns(RuntimeWarning, match="saturates"):
        want = jax_motion.estimate_motion_vector(
            f0, f1, 15, 5, seed=sd, seed_mode=seed_mode, seed_bound=8)
    np.testing.assert_array_equal(got, np.asarray(want))
    # the clamped base is what the oracle gets when handed the clamped seed
    clamped = np.clip(np.trunc(sd), -8, 8)
    ref = onp.estimate_motion_vector(f0, f1, 15, 5, seed=clamped, seed_mode="fixed")
    np.testing.assert_array_equal(got, sd + ref if seed_mode == "shipped" else ref)
    # no clamp, no warning: the unclamped oracle
    free = _port(f0, f1, 15, 5, seed=sd, seed_mode=seed_mode, seed_bound="none")
    np.testing.assert_array_equal(
        free, onp.estimate_motion_vector(f0, f1, 15, 5, seed=sd, seed_mode=seed_mode))


def test_auto_bound_is_sized_from_the_seed(pair):
    f0, f1 = pair
    sd = _seed(30, seed=3)  # reaches 29: the bound 32 holds it, so no warning
    got = _port(f0, f1, 15, 5, seed=sd, seed_mode="fixed")
    np.testing.assert_array_equal(
        got, onp.estimate_motion_vector(f0, f1, 15, 5, seed=sd, seed_mode="fixed"))
    with pytest.warns(RuntimeWarning, match="seed_bound=32"):
        _port(f0, f1, 15, 5, seed=_seed(40, seed=3), seed_mode="fixed")


def test_constant_image_takes_the_first_minimum():
    # every interior candidate ties at cost 0: the first in row-major (dy, dx)
    # order wins each round, so the centre walks to (-sum(steps), -sum(steps))
    # wherever neither the patch nor that candidate touches the zero padding
    f = np.full((40, 48), 93, np.uint8)
    got = _port(f, f, 15, 5)
    np.testing.assert_array_equal(got, onp.estimate_motion_vector(f, f, 15, 5))
    assert (got[16:-16, 16:-16] == -8).all()
    assert not (got[:8, :8] == -8).any()


def test_zero_padding_outside_the_image():
    # a bright frame: windows that leave the image read zeros and cost more
    rng = np.random.default_rng(4)
    f0 = rng.integers(200, 256, (20, 28), dtype=np.uint8)
    f1 = np.roll(f0, (3, -4), (0, 1))
    for costfn in ("sad", "ssd"):
        got = _port(f0, f1, 15, 5, costfn=costfn)
        np.testing.assert_array_equal(got, onp.estimate_motion_vector(f0, f1, 15, 5, costfn=costfn))
    sd = _seed(25, (20, 28), 5)  # centres far outside a 20 x 28 image
    got = _port(f0, f1, 15, 5, seed=sd, seed_mode="fixed", seed_bound="none")
    np.testing.assert_array_equal(
        got, onp.estimate_motion_vector(f0, f1, 15, 5, seed=sd, seed_mode="fixed"))


@pytest.mark.parametrize("costfn", ["wsad_shipped", "wsad"])
def test_float_costs_match_oracle(pair, costfn):
    f0, f1 = pair
    want = onp.estimate_motion_vector(f0, f1, 15, 5, costfn=costfn)
    got = _port(f0, f1, 15, 5, costfn=costfn)
    # float32 sums in another order: near-tied candidates can flip
    assert (got == want).all(axis=-1).mean() > 0.99
    with pytest.raises(ValueError, match="requires method='exact'"):
        _port(f0, f1, 15, 5, costfn=costfn, method="fast")


def test_exact_pallas_kernel_in_interpret_mode(pair):
    f0, f1 = pair[0][:16, :24], pair[1][:16, :24]
    want = np.asarray(me_exact_pallas(f0, f1, 9, 3, interpret=True))
    np.testing.assert_array_equal(_port(f0, f1, 9, 3), want)


def test_seeded_pallas_kernel_in_interpret_mode(pair):
    f0, f1 = pair[0][:16, :24], pair[1][:16, :24]
    sd = _seed(12, (16, 24), 6)  # beyond the bound 8: the clamp is the kernel's
    want = np.asarray(
        me_exact_pallas_seeded(f0, f1, sd, 9, 3, "sad", "shipped", 8, interpret=True))
    with pytest.warns(RuntimeWarning, match="saturates"):
        got = _port(f0, f1, 9, 3, seed=sd, seed_bound=8)
    np.testing.assert_array_equal(got, want)


FAST_FORMS = {"residual": ("auto", -1), "clamped": (4, 4), "gather": ("gather", None)}


@pytest.mark.parametrize("form", list(FAST_FORMS))
@pytest.mark.parametrize("seeded", [False, True])
def test_fast_equals_jax(pair, seeded, form):
    f0, f1 = pair
    warp_bound, jax_wb = FAST_FORMS[form]
    sd = _seed(7, seed=7) if seeded else None
    kw = {"seed": sd, "seed_mode": "shipped", "method": "fast", "warp_bound": warp_bound}
    if seeded and form == "clamped":
        with pytest.warns(RuntimeWarning, match="warp_bound=4"):
            got = _port(f0, f1, 15, 5, **kw)
    else:
        got = _port(f0, f1, 15, 5, **kw)
    want = jax_motion._estimate_2d_fast(
        f0, f1, sd if seeded else np.zeros((1,), np.float32), 15, 5, "shipped", seeded, "sad",
        warp_bound=jax_wb)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_fast_pallas_kernel_in_interpret_mode(pair):
    f0, f1 = pair
    sd = _seed(7, seed=8)
    for seed in (None, sd):
        want = jax_motion._fast_pallas(f0, f1, seed, 15, 5, "fixed", -1, "sad", interpret=True)
        got = _port(f0, f1, 15, 5, seed=seed, seed_mode="fixed", method="fast")
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("geometry, costfn", [((9, 3), "ssd"), ((11, 5), "sad")])
def test_fast_batched_other_geometries_equal_jax(pair, geometry, costfn):
    f0, f1 = pair
    b0, b1 = np.stack([f0, f1]), np.stack([f1, f0])
    got = _port(b0, b1, *geometry, method="fast", costfn=costfn)
    for n in range(2):
        want = jax_motion._estimate_2d_fast(
            b0[n], b1[n], np.zeros((1,), np.float32), *geometry, "shipped", False, costfn,
            warp_bound=-1)
        np.testing.assert_array_equal(got[n], np.asarray(want))


def test_wrappers_take_the_plain_versions_on_the_cpu(pair):
    f0, f1 = (torch.from_numpy(a)[None] for a in pair)
    sd = torch.from_numpy(_seed(6))[None]
    _build.reset_launches()
    assert torch.equal(kmotion.me_exact_kernel(f0, f1, 15, 5, "ssd", sd, 8, "fixed"),
                       kmotion.me_exact(f0, f1, 15, 5, "ssd", sd, 8, "fixed"))
    assert torch.equal(kmotion.me_fast_kernel(f0, f1), kmotion.me_fast(f0, f1))
    assert all(v == 0 for v in _build.LAUNCHES.values())
    assert {"me_exact", "me_fast_round", "me_fast_median"} <= set(_build.LAUNCHES)


def test_input_rules(pair):
    f0, f1 = pair
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        ops.estimate_motion_vector(f0, f1)
    with pytest.raises(TypeError, match="uint8"):
        _port(f0.astype(np.float32), f1.astype(np.float32))
    with pytest.raises(ValueError, match="channels-last"):
        _port(np.zeros((8, 8, 3), np.uint8), np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(ValueError, match="warp_bound"):
        _port(f0, f1, method="fast", warp_bound=-2)
    with pytest.raises(ValueError, match="unknown costfn"):
        _port(f0, f1, costfn="ncc")
    # a tensor stays on its device
    out = ops.estimate_motion_vector(torch.from_numpy(f0), torch.from_numpy(f1), 9, 3)
    assert out.device.type == "cpu" and tuple(out.shape) == (H, W, 2)


@pytest.mark.parametrize("geometry, seeded, bound, want", [
    # 32 x 8 pixels grown by 2 + (5 + 2 + 1) on each side, rows padded to 4 + 8 bytes
    ((15, 5), False, None, (8 + 20) * (32 + 20 + 8)),
    ((9, 3), False, None, (8 + 10) * (32 + 10 + 2 + 8)),
    # the seed's clamp adds the bound on each side
    ((15, 5), True, 32, (8 + 84) * (32 + 84 + 8)),
    # no bound, or a window above the cap: the cap; blocks whose own
    # window does not fit read frame 1 from device memory
    ((15, 5), True, None, kmotion.ME_WINDOW_CAP),
    ((15, 5), True, 1000, kmotion.ME_WINDOW_CAP),
])
def test_exact_kernel_window_from_steps_patch_and_bound(geometry, seeded, bound, want):
    steps = kmotion.me_steps(*geometry)
    assert kmotion.me_window_bytes(steps, geometry[1], seeded, bound) == want
