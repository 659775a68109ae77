"""PyTorch port: the identity the fast search's round kernel
(``csrc/me_fast_round.cu``) rests on, on the CPU. A numpy emulation of its
box-sum form (per candidate, the difference plane masked to the image, a
vertical running sum down each column, a horizontal box sum, the first
minimum in row-major (dy, dx) order) must equal the plain version's round
(``kernels.motion.fast_round``) and, with the 3x3 median, its iteration
(``kernels.motion.me_fast``), for SAD and SSD, on widths around column
w - 2 of the kernel's tiles and warps and on frames narrower than a patch.
The kernel itself is held against the plain version on the card by
chip_smoke.py."""

import numpy as np
import pytest
import torch

from oclcomputervision_tpu_torch.kernels import motion as kmotion

torch.set_num_threads(2)


def box_sum_round(f0, f1, dy, dx, step, ps, costfn):
    """One round as the kernel computes it, in numpy int64."""
    n, h, w = f0.shape
    pm = ps // 2
    ys, xs = np.mgrid[0:h, 0:w]
    ty, tx = ys + dy, xs + dx
    inside = (ty >= 0) & (ty < h) & (tx >= 0) & (tx < w)
    w1 = np.where(inside, f1[np.arange(n)[:, None, None], ty.clip(0, h - 1), tx.clip(0, w - 1)],
                  0).astype(np.int64)
    w1p = np.pad(w1, ((0, 0), (step, step), (step, step)))
    a = f0.astype(np.int64)
    costs = []
    for oy in (-step, 0, step):
        for ox in (-step, 0, step):
            d = a - w1p[:, step + oy : step + oy + h, step + ox : step + ox + w]
            d = d * d if costfn == "ssd" else np.abs(d)  # zero outside: padded below
            dp = np.pad(d, ((0, 0), (pm + 1, pm), (0, 0)))
            # vertical running sum: add the row entering the window, subtract
            # the one leaving it (row y's window is rows y - pm .. y + pm)
            cum = np.cumsum(dp, axis=1)
            vert = cum[:, ps:, :] - cum[:, :-ps, :]
            vp = np.pad(vert, ((0, 0), (0, 0), (pm + 1, pm)))
            cum = np.cumsum(vp, axis=2)
            costs.append(cum[:, :, ps:] - cum[:, :, :-ps])
    costs = np.stack(costs)
    best = costs.argmin(axis=0)  # argmin returns the first minimum
    return dy + (best // 3 - 1) * step, dx + (best % 3 - 1) * step


def median3x3(a):
    h, w = a.shape[-2:]
    p = np.pad(a, ((0, 0), (1, 1), (1, 1)), mode="edge")
    win = np.stack([p[:, j : j + h, i : i + w] for j in range(3) for i in range(3)])
    return np.median(win, axis=0).astype(a.dtype)


# (n, h, w): at patch 5 a kernel tile is 112 columns and a warp's outputs
# 28, so widths 113, 114, 29 and 30 put column w - 2 on the last column of a
# tile or warp and on the first of the next; the others are narrower and
# shorter than a patch or a tile
SHAPES = [(1, 19, 113), (1, 17, 114), (2, 9, 29), (1, 12, 30), (1, 6, 3), (2, 3, 2), (1, 1, 7)]


@pytest.mark.parametrize("costfn", ["sad", "ssd"])
@pytest.mark.parametrize("shape", SHAPES)
def test_box_sum_round_equals_the_plain_round(shape, costfn):
    rng = np.random.default_rng(shape[2] * 7 + len(costfn))
    f0, f1 = (rng.integers(0, 256, shape, dtype=np.uint8) for _ in range(2))
    if costfn == "ssd":  # differences of 255: the largest squares
        f0[..., ::2] = 0
        f1[..., ::2] = 255
    dy, dx = (rng.integers(-6, 7, shape) for _ in range(2))
    for ps, step in ((5, 5), (5, 1), (3, 4), (1, 2)):
        want = kmotion.fast_round(*(torch.from_numpy(np.ascontiguousarray(a))
                                    for a in (f0, f1, dy, dx)), step, ps, costfn)
        got = box_sum_round(f0, f1, dy, dx, step, ps, costfn)
        np.testing.assert_array_equal(got[0], want[0].numpy())
        np.testing.assert_array_equal(got[1], want[1].numpy())


@pytest.mark.parametrize("costfn", ["sad", "ssd"])
@pytest.mark.parametrize("search, ps", [(15, 5), (9, 3), (11, 5)])
def test_box_sum_iteration_equals_me_fast(search, ps, costfn):
    rng = np.random.default_rng(search + ps)
    shape = (2, 21, 114)
    f0 = rng.integers(0, 256, shape, dtype=np.uint8)
    f1 = np.roll(f0, (2, -3), (1, 2)) ^ rng.integers(0, 8, shape, dtype=np.uint8)
    dy = np.zeros(shape, np.int64)
    dx = np.zeros(shape, np.int64)
    for step in kmotion.me_steps(search, ps):
        dy, dx = box_sum_round(f0, f1, dy, dx, step, ps, costfn)
        dy, dx = median3x3(dy), median3x3(dx)
    want = kmotion.me_fast(torch.from_numpy(f0), torch.from_numpy(f1), search, ps, costfn)
    np.testing.assert_array_equal(np.stack([dx, dy], -1).astype(np.float32), want.numpy())


def test_round_wrapper_refuses_what_the_kernel_does_not_take():
    f = torch.zeros((1, 8, 8), dtype=torch.uint8, device="meta")
    s = torch.zeros((1, 8, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        kmotion.fast_round_kernel(f, f, s, s, 1)
    # a CPU tensor takes the plain round: on equal frames every cost ties and
    # the first candidate, (-step, -step), wins
    c = torch.zeros((1, 8, 8), dtype=torch.uint8)
    z = torch.zeros((1, 8, 8), dtype=torch.int32)
    got = kmotion.fast_round_kernel(c, c, z, z, 2, 5)
    assert all(torch.equal(g, torch.full((1, 8, 8), -2)) for g in got)
