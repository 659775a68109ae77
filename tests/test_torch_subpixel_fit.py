"""PyTorch port: the subpixel fit (``ops.refine_flow_subpixel``, and each
``ocv.motion.subpixel`` stage of the pyramid).

On the CPU: the plain version (``kernels.motion.subpixel_fit``) against the
JAX package's ``refine_flow_subpixel`` bit for bit on the cases the kernel
must get right (flows out of the frame, displacements far beyond the halo,
patches 3, 5 and 7, frames no tile divides, a batch, SSD sums past 2^24,
-0.0 and +0.0 flows); the wrapper's plain path and its refusals; and, by
reading ``csrc/subpixel_fit.cu``, the name the benchmark's glue reader finds
the kernel by and the patch cap.

On the card (marker ``cuda``, skipped without one): the kernel against the
plain version on the card bit for bit, one launch and no host sync a call,
36 launches a hybrid pyramid call, and the kernel and plain pyramids equal.
Run there with the repository's card command, ``python -m pytest -p
no:cacheprovider -m cuda tests/`` (this file imports JAX only inside the
fixture that compares with it).
"""

import os
import re

import numpy as np
import pytest
import torch

from oclcomputervision_tpu_torch import ops
from oclcomputervision_tpu_torch.kernels import _build
from oclcomputervision_tpu_torch.kernels import motion as kmotion
from oclcomputervision_tpu_torch.ops import motion as om

torch.set_num_threads(2)

CU = os.path.join(os.path.dirname(kmotion.__file__), "csrc", "subpixel_fit.cu")
SHAPE = (2, 37, 45)  # a batch of two; 37 x 45 is no multiple of the kernel's 16 x 32 tile


@pytest.fixture(scope="module")
def jax_motion():
    import jax

    from oclcomputervision_tpu.ops import motion

    yield motion
    jax.clear_caches()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the subpixel fit kernel has no CPU form")
    return torch.device("cuda")


def frames(rng, shape, kind):
    """Two uint8 frames: 'shift' a noisy copy of frame 0 moved by (1, -2),
    'far' frames whose SSD over a large patch passes 2^24 (frame 0 near 255,
    frame 1 near 0), 'random' unrelated noise."""
    if kind == "far":
        return ((255 - rng.integers(0, 12, shape)).astype(np.uint8),
                rng.integers(0, 12, shape).astype(np.uint8))
    f0 = rng.integers(0, 256, shape, dtype=np.uint8)
    if kind == "random":
        return f0, rng.integers(0, 256, shape, dtype=np.uint8)
    f1 = np.roll(f0, (1, -2), (-2, -1)).astype(int) + rng.integers(-5, 6, shape)
    return f0, np.clip(f1, 0, 255).astype(np.uint8)


def flows(rng, shape, far=60):
    """float32 [*shape, 2]: 40 % uniform in [-far, far] (far outside a small
    frame and the kernel's halo), the rest small integers plus 0, +-0.25,
    +-0.5, -0.4, 1.5 or 2.5 (rounded half to even), and 5 % -0.0, 5 % +0.0."""
    fl = rng.uniform(-far, far, (*shape, 2))
    near = rng.integers(-3, 4, fl.shape) + rng.choice([0, 0.25, -0.25, 0.5, -0.5, -0.4, 1.5, 2.5],
                                                      fl.shape)
    fl = np.where(rng.random(fl.shape) < 0.6, near, fl).astype(np.float32)
    fl[rng.random(fl.shape) < 0.05] = -0.0
    fl[rng.random(fl.shape) < 0.05] = 0.0
    return fl


def bits(a):
    """float32 values as their bits: equal bits, equal values and signs."""
    return np.asarray(a, np.float32).view(np.int32)


def plain(f0, f1, fl, patch, costfn):
    return kmotion.subpixel_fit(*(torch.from_numpy(a) for a in (f0, f1, fl)), patch, costfn).numpy()


@pytest.mark.parametrize("costfn", ["sad", "ssd"])
@pytest.mark.parametrize("patch", [3, 5, 7])
def test_plain_equals_jax(patch, costfn, jax_motion):
    rng = np.random.default_rng(10 * patch + len(costfn))
    f0, f1 = frames(rng, SHAPE, "shift")
    fl = flows(rng, SHAPE)
    want = np.asarray(jax_motion.refine_flow_subpixel(f0, f1, fl, patch, costfn))
    got = plain(f0, f1, fl, patch, costfn)
    np.testing.assert_array_equal(bits(got), bits(want))
    # some vectors took a subpixel offset, some kept their integer flow
    frac = got != np.round(got)
    assert 0 < frac.sum() < frac.size
    # a rounded -0.0 comes back +0.0 where the offset is 0
    assert not np.signbit(got[got == 0]).any()


def test_plain_equals_jax_on_ssd_sums_past_2_24(jax_motion):
    """17 x 17 patches of differences near 255: the integer costs pass 2^24
    and round on their conversion to float32, alike on both sides."""
    rng = np.random.default_rng(17)
    f0, f1 = frames(rng, SHAPE, "far")
    fl = flows(rng, SHAPE, far=3)
    want = np.asarray(jax_motion.refine_flow_subpixel(f0, f1, fl, 17, "ssd"))
    got = plain(f0, f1, fl, 17, "ssd")
    np.testing.assert_array_equal(bits(got), bits(want))
    d = f0.astype(np.int64) - f1
    sums = np.lib.stride_tricks.sliding_window_view(d[0] ** 2, (17, 17)).sum((-2, -1))
    assert (sums[sums > 2**24] % 2).any()  # an odd integer past 2^24 is no float32


def test_wrapper_takes_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(3)
    f0, f1 = (torch.from_numpy(a) for a in frames(rng, SHAPE, "shift"))
    fl = torch.from_numpy(flows(rng, SHAPE))
    before = dict(_build.LAUNCHES)
    for patch, costfn in ((5, "sad"), (3, "ssd"), (4, "sad"), (33, "ssd")):
        assert torch.equal(kmotion.subpixel_fit_kernel(f0, f1, fl, patch, costfn),
                           kmotion.subpixel_fit(f0, f1, fl, patch, costfn))
    got = ops.refine_flow_subpixel(f0[0], f1[0], fl[0], device="cpu")
    assert torch.equal(got, kmotion.subpixel_fit(f0[:1], f1[:1], fl[:1], 5, "sad")[0])
    assert dict(_build.LAUNCHES) == before


def test_wrapper_refusals():
    """What the kernel cannot take raises before any launch (the shapes and
    arguments on meta tensors, which are not CUDA tensors either)."""
    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    g = meta((2, 8, 9), torch.uint8)
    fl = meta((2, 8, 9, 2), torch.float32)
    fit = kmotion.subpixel_fit_kernel
    with pytest.raises(ValueError, match="costfn"):
        fit(g, g, fl, 5, "wsad")
    for patch in (0, 4, kmotion.SUBPIXEL_MAX_PATCH + 2):
        with pytest.raises(ValueError, match="patch size"):
            fit(g, g, fl, patch, "sad")
    with pytest.raises(ValueError, match="frames differ"):
        fit(g, meta((2, 8, 10), torch.uint8), fl)
    with pytest.raises(ValueError, match="must be float32"):
        fit(g, g, meta((2, 8, 9, 1), torch.float32))
    with pytest.raises(ValueError, match=r"\[B, H, W\]"):
        fit(meta((8, 9), torch.uint8), meta((8, 9), torch.uint8), meta((8, 9, 2), torch.float32))
    with pytest.raises(ValueError, match="CUDA tensor"):
        fit(g, g, fl)


def test_kernel_name_and_patch_cap_in_the_source():
    """The benchmark counts as glue every device kernel not named
    ``<LAUNCHES key>_kernel`` (whole word); the wrapper's cap is the .cu's."""
    assert "subpixel_fit" in _build.LAUNCHES
    assert "ocvk_subpixel_fit" in _build._SIGNATURES
    with open(CU) as f:
        src = f.read()
    assert re.search(r"__global__[^;{]*\bsubpixel_fit_kernel\(", src)
    assert int(re.search(r"kMaxPatch = (\d+);", src).group(1)) == kmotion.SUBPIXEL_MAX_PATCH
    assert re.search(r'extern "C" int ocvk_subpixel_fit\(', src)


def test_stages_carry_the_fit():
    assert om.KERNEL_STAGES.subpixel is kmotion.subpixel_fit_kernel
    assert om.PLAIN_STAGES.subpixel is kmotion.subpixel_fit


# the pyramid levels of the motion cell's 4 VGA pairs, frames no tile
# divides, one pixel wide or tall
CARD_SHAPES = [(4, 480, 640), (4, 240, 320), (4, 120, 160), (3, 37, 101), (2, 1, 131),
               (1, 129, 1), (1, 1, 1)]


def card_equal(got, want):
    torch.cuda.synchronize()
    return got.shape == want.shape and torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("costfn", ["sad", "ssd"])
def test_card_kernel_equals_plain_on_random_flows(costfn, card):
    rng = np.random.default_rng(len(costfn))
    for i, shape in enumerate(CARD_SHAPES):
        for kind in ("shift", "random", "far"):
            f0, f1 = (torch.from_numpy(a).to(card) for a in frames(rng, shape, kind))
            fl = torch.from_numpy(flows(rng, shape)).to(card)
            if i % 2:  # a view one float into its allocation: no alignment asked
                fl = torch.cat([fl.new_zeros(1), fl.reshape(-1)])[1:].reshape(fl.shape)
            for patch in (1, 3, 5, 7, 17, kmotion.SUBPIXEL_MAX_PATCH):
                got = kmotion.subpixel_fit_kernel(f0, f1, fl, patch, costfn)
                want = kmotion.subpixel_fit(f0, f1, fl, patch, costfn)
                assert card_equal(got, want), (shape, kind, patch)


@pytest.mark.cuda
@pytest.mark.parametrize("costfn", ["sad", "ssd"])
def test_card_kernel_equals_plain_on_the_pyramids_flows(costfn, card):
    """Every fit of the motion cell's call (3 levels, 12 rounds) on the
    Middlebury pair and its reverse: the kernel on the flow the plain
    pyramid hands each fit."""
    from oclcomputervision_tpu_torch.utils import load_gray

    a, b = load_gray("frame10.png"), load_gray("frame11.png")
    f0, f1 = (torch.from_numpy(np.stack(p)).to(card) for p in ((a, b), (b, a)))
    seen = []

    def record(g0, g1, flow, patch, cost):
        got = kmotion.subpixel_fit_kernel(g0, g1, flow, patch, costfn)
        seen.append(card_equal(got, kmotion.subpixel_fit(g0, g1, flow, patch, costfn)))
        return kmotion.subpixel_fit(g0, g1, flow, patch, cost)

    stages = om.PLAIN_STAGES._replace(subpixel=record)
    om._pyramid(f0, f1, 3, 15, 5, "fixed", "fast", 9, "auto", "auto", 12, "auto", stages)
    assert len(seen) == 36 and all(seen), seen


@pytest.mark.cuda
def test_card_one_launch_and_no_sync_a_call(card):
    rng = np.random.default_rng(1)
    f0, f1 = (torch.from_numpy(a).to(card) for a in frames(rng, (4, 480, 640), "shift"))
    fl = torch.from_numpy(flows(rng, (4, 480, 640))).to(card)
    ops.refine_flow_subpixel(f0, f1, fl)  # the library's build and load
    torch.cuda.synchronize()
    before = dict(_build.LAUNCHES)
    torch.cuda.set_sync_debug_mode("error")
    try:
        ops.refine_flow_subpixel(f0, f1, fl)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    moved = {k: v - before[k] for k, v in _build.LAUNCHES.items() if v != before[k]}
    assert moved == {"subpixel_fit": 1}


@pytest.mark.cuda
def test_card_wrapper_refusals(card):
    f = torch.zeros((2, 8, 9), dtype=torch.uint8, device=card)
    fl = torch.zeros((2, 8, 9, 2), dtype=torch.float32, device=card)
    with pytest.raises(ValueError, match="float32"):
        kmotion.subpixel_fit_kernel(f, f, fl.double())
    with pytest.raises(ValueError, match="uint8"):
        kmotion.subpixel_fit_kernel(f.float(), f, fl)
    with pytest.raises(ValueError, match="contiguous"):
        kmotion.subpixel_fit_kernel(f, f, fl.transpose(1, 2).contiguous().transpose(1, 2))


@pytest.mark.cuda
def test_card_hybrid_pyramid_launches_36_fits_and_equals_plain(card):
    """The motion cell's call: 3 levels, search 15, patch 5, the hybrid
    schedule, 9 x 9 medians, 12 subpixel rounds a level; the kernel stages'
    flows equal the plain stages' at every level."""
    rng = np.random.default_rng(0)
    f0 = torch.from_numpy(rng.integers(0, 256, (4, 480, 640), dtype=np.uint8)).to(card)
    f1 = torch.roll(f0, (2, -3), (1, 2))
    before = _build.LAUNCHES["subpixel_fit"]
    flows_k = ops.estimate_motion_pyramid(f0, f1, 3, 15, 5, method="fast", smooth=9, subpixel=12)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["subpixel_fit"] - before == 36
    flows_p = om._pyramid(f0, f1, 3, 15, 5, "fixed", "fast", 9, "auto", "auto", 12, "auto",
                          om.PLAIN_STAGES)
    for k, p in zip(flows_k, flows_p):
        assert torch.equal(k, p)  # == : the median may give a zero the other sign
