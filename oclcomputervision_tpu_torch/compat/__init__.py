"""Drop-in compatibility layer mirroring the reference's public API.

Port of ``oclcomputervision_tpu/compat``. A user of
saturdaycoder/oclComputerVision can import these names with the reference's
signatures and get numpy results back:

- calc_transfer_func / histeq_global / histeq_local_block
  (histeq/eq_global.py:10,39, histeq/eq_local_block.py:10)
- gaussian_pyramid (pyramid/pyramid.py:7)
- estimate_motion_vector / mv2hsv (motion_estimation/me_pyramid.py:130,7)
- read_flo / write_flo / upscale_mv (me_test.py:12,27,51)
- Raisr.upsample(src, dst, scale_factor) (super_resolution/raisr.py:85)
- Utility.bilinear/bicubic/bilinear_lds/bicubic_lds (basic/interpolation.py)

``use_gpu=True`` (and every entry point without a ``use_gpu``) runs the
port's ops on the card, and raises where torch sees none; ``use_gpu=False``
runs the numpy oracles (the reference's CPU paths). The keyword ``device``
(on the functions and the class constructors) names another device for the
ops: ``device="cpu"`` runs their plain PyTorch versions. Nothing falls back
to the oracle on its own. Timing prints are preserved in shape ("took GPU:
... ms") and report the call's wall time, the card's work included.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from oclcomputervision_tpu_torch import ops
from oclcomputervision_tpu_torch.oracle import histeq as oracle_histeq
from oclcomputervision_tpu_torch.oracle import motion as oracle_motion
from oclcomputervision_tpu_torch.utils import read_flo, write_flo  # noqa: F401
from oclcomputervision_tpu_torch.utils.profiling import timed


def _np(x) -> np.ndarray:
    return x.cpu().numpy()


def calc_transfer_func(hist, alpha, punch, clip):
    return oracle_histeq.calc_transfer_func(hist, alpha, punch, clip)


# --- module-level ME helpers (me_pyramid.py:15-127) -------------------
# Reference user code calls these per-pixel inside Python loops, so they
# are plain NumPy (a device launch per 5x5 patch would be absurd); the
# card's search lives in ops.motion and is bit-identical to the loop these
# helpers express.

#: Headless import-parity twins of the reference's cv2-window toggles
#: (me_pyramid.py:50,129). Setting them has no effect here.
visualizeSearch = False
visualizeME = False


def gaussian2d(shape=(3, 3), sigma=0.5):
    """MATLAB fspecial('gaussian')-style mask (me_pyramid.py:15-27)."""
    return oracle_motion.gaussian2d(shape, sigma)


def SSD(p0, p1):
    """Sum of squared differences of two 2-D patches (me_pyramid.py:29-34)."""
    assert len(p0.shape) == 2 and p0.shape == p1.shape
    return float(oracle_motion.patch_cost(
        p0.astype(np.float32), p1.astype(np.float32), "ssd"))


def SAD(p0, p1):
    """Sum of absolute differences of two 2-D patches (me_pyramid.py:36-41)."""
    assert len(p0.shape) == 2 and p0.shape == p1.shape
    return float(oracle_motion.patch_cost(
        p0.astype(np.float32), p1.astype(np.float32), "sad"))


def WSAD(p0, p1, sigma=2.0):
    """Gaussian-weighted SAD incl. the np.dot-as-MATMUL quirk
    (me_pyramid.py:43-48; SURVEY.md fidelity note 9)."""
    assert len(p0.shape) == 2 and p0.shape == p1.shape
    w = oracle_motion.gaussian2d(p0.shape, sigma).astype(np.float32)
    return float(np.abs(p0.astype(np.float32) @ w - p1.astype(np.float32) @ w).sum())


def get_displacement(patch, searchRegion, step):
    """Exhaustive stride-``step`` SAD scan of ``searchRegion``
    (me_pyramid.py:51-87): returns (drow, dcol) of the first strict
    minimum relative to the region's patch-aligned center, or (0, 0)
    when the region is smaller than the patch."""
    patch = np.asarray(patch)
    searchRegion = np.asarray(searchRegion)
    ph, pw = patch.shape
    if searchRegion.shape[0] < ph or searchRegion.shape[1] < pw:
        return 0, 0
    center = (searchRegion.shape[0] // 2 - ph // 2, searchRegion.shape[1] // 2 - pw // 2)
    best = (np.inf, -1, -1)
    for row in range(0, searchRegion.shape[0] + 1 - ph, step):
        for col in range(0, searchRegion.shape[1] + 1 - pw, step):
            sad = SAD(patch, searchRegion[row : row + ph, col : col + pw])
            if sad < best[0]:
                best = (sad, row, col)
    assert best[1] >= 0 and best[2] >= 0
    return best[1] - center[0], best[2] - center[1]


def get_region_padded(im, T, B, L, R, size):
    """``im[T:B, L:R]`` zero-padded to the window (me_pyramid.py:89-127),
    reproducing the shipped margin arithmetic branch-for-branch - incl.
    its quirk that a window overhanging BOTH edges of an axis (possible
    only when the window is taller/wider than the image) comes back
    short, because the T<0 branch wins and never re-checks B > H."""
    im = np.asarray(im)
    h, w = im.shape[:2]

    def margins(lo, hi, n):
        # returns (clamped lo, clamped hi, pad_before, pad_after)
        if hi < 0:
            return 0, 0, size, 0
        if lo < 0:  # and hi >= 0
            return 0, hi, size - hi, 0
        if lo > n:
            return n, n, 0, size
        if hi > n:  # and lo <= n
            return lo, n, 0, size - (n - lo)
        return lo, hi, 0, 0

    T, B, mt, mb = margins(T, B, h)
    L, R, ml, mr = margins(L, R, w)
    region = im[T:B, L:R]
    return np.pad(region, ((mt, mb), (ml, mr)), mode="constant")


def histeq_global(gray, alpha=1, punch=0.05, clip=2, use_gpu=True, *, device=None):
    if use_gpu:
        out, ms = timed(
            ops.histeq_global, gray, float(alpha), float(punch), float(clip), device=device
        )
        # the reference prints a three-part breakdown - hist GPU + eq
        # GPU + transfer-func CPU ms (eq_global.py:56) - because its
        # pipeline crosses the host boundary twice with a CPU stage
        # between. Here the transfer function stays on the device too, so
        # the whole time lands in the first figure and the other two are
        # structurally zero; the print shape is preserved for output parity.
        print(
            "global histogram equalization took GPU: {:.3f} + {:.3f} ms, CPU: {:.3f} ms".format(
                ms, 0.0, 0.0
            )
        )
        return _np(out)
    return oracle_histeq.histeq_global(gray, alpha, punch, clip)


def histeq_local_block(
    gray, alpha=0.5, punch=0.05, clip=3, blockshape=(256, 256), use_gpu=True, *, device=None
):
    if use_gpu:
        out, ms = timed(
            ops.histeq_local_block,
            gray,
            float(alpha),
            float(punch),
            float(clip),
            tuple(blockshape),
            device=device,
        )
        print(
            "local histogram equalization (block-based) took GPU: {:.3f} ms".format(ms)
        )
        return _np(out)
    out = oracle_histeq.histeq_local_block(
        np.array(gray), alpha, punch, clip, blockshape
    )
    # the reference's CPU path mutates its input IN PLACE and returns it
    # (eq_local_block.py:41-76's gray[i, j] = v1); reproduce that
    # observable contract for writable ndarray inputs
    if isinstance(gray, np.ndarray) and gray.flags.writeable:
        gray[...] = out
        return gray
    return out


def gaussian_pyramid(img, scale=2, depth=3, *, device=None):
    return [_np(p) for p in ops.gaussian_pyramid(img, scale, depth, device=device)]


def estimate_motion_vector(
    gray0, gray1, searchSize=15, patchSize=5, seed=None, pyrScale=1, *, device=None
):
    del pyrScale  # display-only in the reference
    return _np(
        ops.estimate_motion_vector(
            gray0, gray1, searchSize, patchSize, seed=seed, device=device
        )
    )


def upscale_mv(mv, scale, *, device=None):
    return _np(ops.upscale_mv(mv, scale, mode="shipped", device=device))


def mv2hsv(mv, scale=1):
    """Flow -> BGR visualization (me_pyramid.py:7-13); needs cv2."""
    import cv2

    mv = np.asarray(mv)
    mag, ang = cv2.cartToPolar(mv[..., 0], mv[..., 1])
    hsv = np.zeros((mv.shape[0], mv.shape[1], 3), np.uint8)
    hsv[..., 0] = ang * 180 / np.pi / 2
    hsv[..., 1] = 255
    hsv[..., 2] = cv2.normalize(mag, None, 0, 255, cv2.NORM_MINMAX)
    bgr = cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)
    return cv2.resize(bgr, (hsv.shape[1] * scale, hsv.shape[0] * scale))


class HistEq:
    """clHistEq-equivalent device runtime (histeq/eq_opencl.py:8).

    Methods mirror the reference's L1 API: each returns
    (numpy array, elapsed_ms). getInstance() keeps the singleton shape
    (on the card; construct ``HistEq(device=...)`` for another device).
    """

    _inst = None

    def __init__(self, *, device=None):
        self.histBins = 256
        self.histThreads = 32
        self.device = device

    @classmethod
    def getInstance(cls):
        if cls._inst is None:
            cls._inst = HistEq()
        return cls._inst

    def histGrid(self, gray) -> Tuple[np.ndarray, float]:
        out, ms = timed(
            ops.hist_grid, gray, (self.histThreads, self.histBins), device=self.device
        )
        return _np(out).astype(np.uint32), ms

    def histeqGlobal(self, gray, mapping) -> Tuple[np.ndarray, float]:
        out, ms = timed(
            ops.apply_lut, np.asarray(gray), np.asarray(mapping, np.uint8), device=self.device
        )
        return _np(out), ms

    def histeqLocalBlock(self, gray, mappings, blockshape) -> Tuple[np.ndarray, float]:
        out, ms = timed(
            ops.apply_block_mappings,
            np.asarray(gray),
            np.asarray(mappings, np.float32),
            tuple(blockshape),
            device=self.device,
        )
        return _np(out), ms


clHistEq = HistEq  # reference class name alias


class Utility:
    """clUtility-equivalent (basic/interpolation.py:16): dst is filled
    in place, per-call elapsed-ms list is returned."""

    def __init__(self, *, device=None):
        self.device = device

    def _run(self, src, dst, method, mapping="align_corners"):
        out, ms = timed(
            ops.resize_uint8, src, dst.shape[:2], method, mapping, device=self.device
        )
        dst[...] = _np(out).reshape(dst.shape)
        return [ms]

    def bilinear(self, src, dst):
        # bilinear_simple's HW-sampler numerics (interpolation.cl:11-13):
        # the reference observably ships TWO bilinear conventions
        # (SURVEY.md fidelity note 11); this name keeps the simple one.
        return self._run(src, dst, "bilinear", mapping="hw_sampler")

    def bilinear_lds(self, src, dst):
        # explicit align-corners math (interpolation.cl:39-70)
        return self._run(src, dst, "bilinear")

    def bicubic(self, src, dst):
        return self._run(src, dst, "bicubic")

    # bicubic_simple computes the same explicit align-corners
    # Catmull-Rom as bicubic_lds (interpolation.cl:92,157) - one function
    # serves both names.
    bicubic_lds = bicubic


clUtility = Utility  # reference class name alias (basic/interpolation.py:16)


class Raisr:
    """ClRaisr-equivalent (super_resolution/raisr.py:18).

    Loads the trained filter bank from assets/raisr_filters_x2.npz
    (the repository ships and trains its own; the reference's filter.p
    asset is missing from its repo).
    """

    def __init__(self, grayMode: int = 0, filters_path: Optional[str] = None,
                 fidelity: str = "full", *, device=None):
        from oclcomputervision_tpu_torch.models.raisr import RaisrModel
        from oclcomputervision_tpu_torch.utils.assets import asset_path

        self.grayMode = grayMode
        path = filters_path or asset_path("raisr_filters_x2.npz")
        self.model = RaisrModel.load(path, fidelity=fidelity, device=device)

    def upsample(self, src, dst, scale_factor) -> list:
        if scale_factor != self.model.cfg.scale:
            print("Fatal. not trained for scale factor {}".format(scale_factor))
            return []
        out, ms = timed(self.model.upsample, src)
        dst[...] = _np(out).reshape(dst.shape)
        return [ms]


ClRaisr = Raisr  # reference class name alias (super_resolution/raisr.py:18)
