"""PyTorch port: the selection the fast search's median kernel
(``csrc/me_fast_median.cu``) computes, on the CPU. A numpy model of the
kernel (threads of 4 columns x 2 rows, rows and columns clamped at the
edges, each column of 3 sorted with the pair of the two middle rows shared,
then med3 of the column minima's maximum, the column medians' median and
the column maxima's minimum) must equal the median of each edge-replicated
3x3 window (``np.median``) and the plain version
(``kernels.motion._median3x3``, Paeth's network) on states from 1 x 1 to
frames wider than the kernel's 128-column tile, with widths that are not a
multiple of 4. The kernel itself is held against the plain version on the
card by chip_smoke.py."""

import numpy as np
import pytest
import torch

from oclcomputervision_tpu_torch.kernels import motion as kmotion

torch.set_num_threads(2)

COLS, ROWS = 4, 2  # csrc/me_fast_median.cu's kCols, kRows: pixels a thread computes


def med3(a, b, c):
    return np.maximum(np.minimum(a, b), np.minimum(np.maximum(a, b), c))


def kernel_model(a):
    """The kernel's median of [n, h, w] int64 states, thread by thread."""
    n, h, w = a.shape
    ty, tx = np.arange(0, h, ROWS), np.arange(0, w, COLS)
    rows = np.clip(ty[:, None] + np.arange(-1, ROWS + 1), 0, h - 1)  # [threads down, 4]
    cols = np.clip(tx[:, None] + np.arange(-1, COLS + 1), 0, w - 1)  # [threads across, 6]
    v = a[:, rows[:, :, None, None], cols[None, None, :, :]]  # [n, down, 4, across, 6]
    pair_lo = np.minimum(v[:, :, 1], v[:, :, 2])
    pair_hi = np.maximum(v[:, :, 1], v[:, :, 2])
    out = np.empty((n, len(ty), ROWS, len(tx), COLS), a.dtype)
    for i, c in enumerate((v[:, :, 0], v[:, :, 3])):
        lo = np.minimum(pair_lo, c)
        mid = np.maximum(pair_lo, np.minimum(pair_hi, c))
        hi = np.maximum(pair_hi, c)
        for k in range(COLS):
            out[:, :, i, :, k] = med3(lo[..., k : k + 3].max(-1),
                                      med3(mid[..., k], mid[..., k + 1], mid[..., k + 2]),
                                      hi[..., k : k + 3].min(-1))
    return out.reshape(n, len(ty) * ROWS, len(tx) * COLS)[:, :h, :w]


def window_median(a):
    """np.median of every edge-replicated 3x3 window."""
    pd = np.pad(a, ((0, 0), (1, 1), (1, 1)), mode="edge")
    win = np.lib.stride_tricks.sliding_window_view(pd, (3, 3), axis=(1, 2))
    return np.median(win.reshape(*a.shape, 9), axis=-1).astype(a.dtype)


@pytest.mark.parametrize("shape", [(1, 1, 1), (1, 1, 9), (1, 7, 1), (2, 20, 17), (1, 3, 2),
                                   (1, 33, 130), (2, 17, 128)])
@pytest.mark.parametrize("amp", [6, 1 << 20])
def test_kernel_selection_is_the_median(shape, amp):
    a = np.random.default_rng(amp + sum(shape)).integers(-amp, amp + 1, shape).astype(np.int64)
    got = kernel_model(a)
    np.testing.assert_array_equal(got, window_median(a))
    np.testing.assert_array_equal(got, kmotion._median3x3(torch.from_numpy(a)).numpy())


def test_median_wrapper_takes_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(5)
    dy, dx = (torch.from_numpy(rng.integers(-9, 10, (2, 11, 13)).astype(np.int32)) for _ in range(2))
    my, mx = kmotion.median3x3_kernel(dy, dx)
    assert torch.equal(my, kmotion._median3x3(dy)) and torch.equal(mx, kmotion._median3x3(dx))
    meta = torch.empty((1, 4, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        kmotion.median3x3_kernel(meta, meta)
