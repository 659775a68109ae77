"""PyTorch port: the k x k flow median (``ops.median_filter_flow``).

On the CPU: the plain version (``kernels.motion.flow_median``: ``F.unfold``
and ``Tensor.median``) against the JAX package's comparator network on
tie-heavy flows like the subpixel rounds' (integers plus offsets in
[-0.5, 0.5], many exact duplicates, -0.0 and +0.0) and on degenerate shapes;
numpy models of what ``csrc/flow_median.cu`` computes (the compiled kernel's
2 x 2 outputs a thread, its shared core sorted once into a band of ranks,
each output's own values sorted and the band and them merged at one rank,
all on the kernel's Batcher networks; the generic kernel's median key built
bit by bit) against ``np.median``; and, by reading the files, the names the
benchmark's glue reader finds the kernels by.

On the card (marker ``cuda``, skipped without one): the kernel against the
plain version on the card, launches and host syncs. Run there with the
repository's card command, ``python -m pytest -p no:cacheprovider -m cuda
tests/`` (this file imports JAX only inside the tests that compare with it).
"""

import os
import re

import numpy as np
import pytest
import torch

from oclcomputervision_tpu_torch import ops
from oclcomputervision_tpu_torch.kernels import _build
from oclcomputervision_tpu_torch.kernels import motion as kmotion

torch.set_num_threads(2)

CU = os.path.join(os.path.dirname(kmotion.__file__), "csrc", "flow_median.cu")
NEG, POS = -(1 << 40), 1 << 40  # -inf and +inf among int64 keys


@pytest.fixture(scope="module")
def jax_motion():
    import jax

    from oclcomputervision_tpu.ops import motion

    yield motion
    jax.clear_caches()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flow median kernel has no CPU form")
    return torch.device("cuda")


def tie_heavy(shape, seed):
    """A float32 [..., 2] flow like the subpixel rounds leave: integers in
    [-6, 6], on 60 % of the vectors plus an offset from a few in [-0.5, 0.5],
    10 % -0.0 and 5 % +0.0."""
    rng = np.random.default_rng(seed)
    offs = np.array([-0.5, -0.25, 0.0, 0.125, 0.3, 0.5], np.float32)
    f = rng.integers(-6, 7, shape).astype(np.float32)
    f += rng.choice(offs, shape) * (rng.random(shape) < 0.6)
    f[rng.random(shape) < 0.1] = -0.0
    f[rng.random(shape) < 0.05] = 0.0
    return f.astype(np.float32)


def window_median(planes, k):
    """np.median of every edge-replicated k x k window of [n, h, w]."""
    r = k // 2
    pd = np.pad(planes, ((0, 0), (r, r), (r, r)), mode="edge")
    win = np.lib.stride_tricks.sliding_window_view(pd, (k, k), axis=(1, 2))
    return np.median(win.reshape(*planes.shape, k * k), axis=-1).astype(np.float32)


def to_key(a):
    """float32 -> int64 keys in the floats' order (the kernel's to_key)."""
    b = a.view(np.int32).astype(np.int64)
    return np.where(b < 0, b ^ 0x7FFFFFFF, b)


def from_key(k):
    b = np.where(k < 0, k ^ 0x7FFFFFFF, k).astype(np.int32)
    return b.view(np.float32)


def network(v):
    """``csrc/flow_median.cu``'s oe_sort on a list of same-shape arrays,
    padded with +inf to a power of two."""
    n = 1 << (len(v) - 1).bit_length()
    v = list(v) + [np.full_like(v[0], POS)] * (n - len(v))
    for a, b in kmotion.oe_sort_pairs(n):
        v[a], v[b] = np.minimum(v[a], v[b]), np.maximum(v[a], v[b])
    return v


def kernel_model(planes, k):
    """flow_median_kernel<k>'s median of [n, h, w] float32 planes, 2 x 2
    outputs at a time from the (k + 1) x (k + 1) union of their windows."""
    n, h, w = planes.shape
    r, core, own, mid = k // 2, (k - 1) ** 2, 2 * k - 1, k * k // 2
    h2, w2 = -(-h // 2) * 2, -(-w // 2) * 2
    rows = np.clip(np.arange(h2 + k) - r, 0, h - 1)
    cols = np.clip(np.arange(w2 + k) - r, 0, w - 1)
    pd = to_key(planes)[:, rows][:, :, cols]
    win = [[pd[:, i : i + h2 : 2, j : j + w2 : 2] for j in range(k + 1)] for i in range(k + 1)]
    srt = network([win[1 + i // (k - 1)][1 + i % (k - 1)] for i in range(core)])
    band = [np.full_like(srt[0], NEG) if q < 0 else (srt[q] if q < core else np.full_like(srt[0], POS))
            for q in range(mid - own, mid + 1)]
    out = np.empty((n, h2, w2), np.int64)
    for dy in (0, 1):
        for dx in (0, 1):
            mine = network([win[k if dy else 0][dx + j] for j in range(k)]
                           + [win[j - k + 1][k if dx else 0] for j in range(k, own)])
            m = band[own]
            for i in range(1, own + 1):
                m = np.minimum(m, np.maximum(band[i - 1], mine[own - i]))
            out[:, dy::2, dx::2] = m
    return from_key(out[:, :h, :w])


def generic_model(planes, k):
    """flow_median_generic_kernel's median: the largest unsigned key with at
    most k * k // 2 window keys below it, built from the top bit."""
    b = planes.view(np.int32).astype(np.int64)
    ukey = np.where(b < 0, ~b & 0xFFFFFFFF, b | 0x80000000)
    r = k // 2
    pd = np.pad(ukey, ((0, 0), (r, r), (r, r)), mode="edge")
    win = np.lib.stride_tricks.sliding_window_view(pd, (k, k), axis=(1, 2)).reshape(*planes.shape, -1)
    res = np.zeros(planes.shape, np.int64)
    for bit in range(31, -1, -1):
        t = res | (1 << bit)
        res = np.where((win < t[..., None]).sum(-1) <= k * k // 2, t, res)
    bits = np.where(res & 0x80000000, res ^ 0x80000000, ~res & 0xFFFFFFFF)
    return bits.astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("k", [3, 5, 7, 9, 11])
def test_plain_equals_jax_on_tie_heavy_flows(k, jax_motion):
    mv = tie_heavy((2, 23, 37, 2), k)
    want = np.asarray(jax_motion.median_filter_flow(mv, k))
    np.testing.assert_array_equal(ops.median_filter_flow(mv, k, device="cpu").numpy(), want)
    np.testing.assert_array_equal(kmotion.flow_median(torch.from_numpy(mv), k).numpy(), want)


# 1 x 1, one row, one column, and windows larger than the frame on both axes
@pytest.mark.parametrize("hw,k", [((1, 1), 3), ((1, 9), 9), ((7, 1), 11), ((3, 4), 9), ((2, 3), 11)])
def test_plain_on_degenerate_shapes(hw, k, jax_motion):
    mv = tie_heavy((*hw, 2), sum(hw) + k)
    want = np.asarray(jax_motion.median_filter_flow(mv, k))
    got = ops.median_filter_flow(mv, k, device="cpu").numpy()
    assert got.shape == mv.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.moveaxis(window_median(np.moveaxis(mv, -1, 0), k), 0, -1))


@pytest.mark.parametrize("shape", [(1, 1, 1), (1, 1, 9), (1, 7, 1), (2, 9, 17), (2, 20, 67), (1, 13, 130)])
@pytest.mark.parametrize("k", [3, 5, 7, 9])
def test_kernel_selection_is_the_median(shape, k):
    rng = np.random.default_rng(k * 100 + sum(shape))
    for planes in (tie_heavy(shape, k + sum(shape)), rng.standard_normal(shape).astype(np.float32)):
        got = kernel_model(planes, k)
        np.testing.assert_array_equal(got, window_median(planes, k))
        flow = torch.from_numpy(np.stack([planes, planes[::-1].copy()], axis=-1))
        np.testing.assert_array_equal(got, kmotion.flow_median(flow, k)[..., 0].numpy())


@pytest.mark.parametrize("k", [1, 3, 11, 13])
def test_generic_selection_is_the_median(k):
    for shape in ((1, 1, 1), (2, 7, 1), (1, 9, 23)):
        for planes in (tie_heavy(shape, k), np.random.default_rng(k).standard_normal(shape).astype(np.float32)):
            np.testing.assert_array_equal(generic_model(planes, k), window_median(planes, k))


def test_kernel_counts_fewer_minmax_than_one_network_a_window():
    """The header's count at k = 9, a third of the JAX package's pruned
    network over 81 values (1324 min and max)."""
    assert [kmotion.flow_median_minmax(k) for k in kmotion.FLOW_MEDIAN_COMPILED] == [28.5, 103, 238, 431]


def test_kernel_names_the_glue_reader_finds():
    """The benchmark counts as glue every device kernel not named
    ``<LAUNCHES key>_kernel`` (whole word): both keys and both CUDA names."""
    assert {"flow_median", "flow_median_generic"} <= set(_build.LAUNCHES)
    with open(CU) as f:
        src = f.read()
    for name in ("flow_median_kernel", "flow_median_generic_kernel"):
        assert re.search(rf"__global__[^;{{]*\b{name}\(", src), name
    assert set(kmotion.FLOW_MEDIAN_COMPILED) == {int(k) for k in re.findall(r"case (\d+): flow_median_kernel<", src)}


def test_wrapper_takes_the_plain_version_on_the_cpu():
    flow = torch.from_numpy(tie_heavy((2, 11, 13, 2), 5))
    before = dict(_build.LAUNCHES)
    assert torch.equal(kmotion.flow_median_kernel(flow, 5), kmotion.flow_median(flow, 5))
    assert dict(_build.LAUNCHES) == before
    meta = torch.empty((1, 4, 4, 2), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        kmotion.flow_median_kernel(meta, 5)
    with pytest.raises(ValueError, match="odd"):
        kmotion.flow_median_kernel(flow, 4)


# the pyramid levels of the motion cell's 4 VGA pairs, and odd, unaligned widths
CARD_SHAPES = [(4, 480, 640), (4, 240, 320), (4, 120, 160), (3, 37, 101), (2, 1, 131), (1, 129, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("k", [3, 5, 7, 9, 11])
def test_card_kernel_equals_plain(k, card):
    for i, shape in enumerate(CARD_SHAPES):
        flow = torch.from_numpy(tie_heavy((*shape, 2), 10 * k + i)).to(card)
        if shape[2] % 2:  # a view one float into its allocation: no alignment asked
            flow = torch.cat([flow.new_zeros(1), flow.reshape(-1)])[1:].reshape(flow.shape)
        got, want = kmotion.flow_median_kernel(flow, k), kmotion.flow_median(flow, k)
        torch.cuda.synchronize()
        assert got.shape == want.shape and bool((got == want).all()), (k, shape)


@pytest.mark.cuda
def test_card_one_launch_and_no_sync_a_call(card):
    flow = torch.from_numpy(tie_heavy((4, 480, 640, 2), 1)).to(card)
    for k, name in ((9, "flow_median"), (11, "flow_median_generic")):
        ops.median_filter_flow(flow, k)  # the library's build and load
        torch.cuda.synchronize()
        before = dict(_build.LAUNCHES)
        torch.cuda.set_sync_debug_mode("error")
        try:
            ops.median_filter_flow(flow, k)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert {key: v - before[key] for key, v in _build.LAUNCHES.items() if v != before[key]} == {name: 1}


@pytest.mark.cuda
def test_card_hybrid_pyramid_launches_38_medians(card):
    """The motion cell's call: 3 levels, search 15, patch 5, the hybrid
    schedule, 9 x 9 medians, 12 subpixel rounds (12 medians on the coarsest
    level, 13 on each refined one)."""
    rng = np.random.default_rng(0)
    f0 = torch.from_numpy(rng.integers(0, 256, (4, 480, 640), dtype=np.uint8)).to(card)
    f1 = torch.roll(f0, (2, -3), (1, 2))
    before = _build.LAUNCHES["flow_median"]
    flows = ops.estimate_motion_pyramid(f0, f1, 3, 15, 5, method="fast", smooth=9, subpixel=12)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flow_median"] - before == 38
    assert [tuple(f.shape) for f in flows] == [(4, 120, 160, 2), (4, 240, 320, 2), (4, 480, 640, 2)]
