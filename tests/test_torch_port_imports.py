"""PyTorch port: it imports neither JAX nor the JAX package, and its own
copies of the JAX package's JAX-free modules (configs, numpy oracles) equal
the originals."""

import ast
import dataclasses
import os

import numpy as np
import pytest

from oclcomputervision_tpu.oracle import histeq as jax_oracle_histeq
from oclcomputervision_tpu.oracle import interpolation as jax_oracle_interp
from oclcomputervision_tpu.ops import _layout as jax_layout
from oclcomputervision_tpu.oracle import motion as jax_oracle_motion
from oclcomputervision_tpu.oracle import pyramid as jax_oracle_pyramid
from oclcomputervision_tpu.oracle import raisr as jax_oracle_raisr
from oclcomputervision_tpu.utils import config as jax_config
from oclcomputervision_tpu.utils import metrics as jax_metrics
from oclcomputervision_tpu_torch._device import as_device
from oclcomputervision_tpu_torch.oracle import histeq as port_oracle_histeq
from oclcomputervision_tpu_torch.oracle import interpolation as port_oracle_interp
from oclcomputervision_tpu_torch.ops import _layout as port_layout
from oclcomputervision_tpu_torch.oracle import motion as port_oracle_motion
from oclcomputervision_tpu_torch.oracle import pyramid as port_oracle_pyramid
from oclcomputervision_tpu_torch.oracle import raisr as port_oracle_raisr
from oclcomputervision_tpu_torch.utils import asset_path, config, metrics
from oclcomputervision_tpu_torch.utils.assets import ASSETS_DIR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "oclcomputervision_tpu_torch")


EXAMPLES = os.path.join(REPO, "examples_torch")


def _port_sources():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    paths += [os.path.join(EXAMPLES, f) for f in os.listdir(EXAMPLES) if f.endswith(".py")]
    return sorted(paths)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "oclcomputervision_tpu")


def test_import_scan_covers_the_ported_modules():
    scanned = {os.path.relpath(p, PORT) for p in _port_sources()}
    for rel in ("ops/interpolation.py", "oracle/interpolation.py", "models/raisr.py",
                "models/pipeline.py", "compat/__init__.py", "ops/raisr.py"):
        assert rel in scanned, rel
    examples = {os.path.basename(p) for p in _port_sources() if os.path.dirname(p) == EXAMPLES}
    jax_examples = {f for f in os.listdir(os.path.join(REPO, "examples")) if f.endswith(".py")}
    assert len(jax_examples) == 6 and jax_examples <= examples, sorted(jax_examples - examples)


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_import_of_jax_or_the_jax_package(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize(
    "name",
    ["HistEqConfig", "LocalHistEqConfig", "ResizeConfig", "PyramidConfig", "MotionConfig",
     "RaisrConfig"],
)
def test_config_copies_equal_jax(name):
    port_cls, jax_cls = getattr(config, name), getattr(jax_config, name)
    fields = [(f.name, f.default, f.type) for f in dataclasses.fields(port_cls)]
    assert fields == [(f.name, f.default, f.type) for f in dataclasses.fields(jax_cls)]
    assert port_cls.__dataclass_params__.frozen and jax_cls.__dataclass_params__.frozen
    assert dataclasses.asdict(port_cls()) == dataclasses.asdict(jax_cls())
    if name == "RaisrConfig":
        for s in (2, 3, 4):
            assert port_cls(scale=s).num_filters == jax_cls(scale=s).num_filters


@pytest.mark.parametrize("module", ["ops.raisr", "utils.metrics", "utils.profiling"])
def test_public_functions_of_jax_modules_are_ported(module):
    import importlib
    import inspect

    jax_mod = importlib.import_module(f"oclcomputervision_tpu.{module}")
    port_mod = importlib.import_module(f"oclcomputervision_tpu_torch.{module}")
    own = {n for n, v in vars(jax_mod).items()
           if not n.startswith("_") and (inspect.isfunction(v) or inspect.isclass(v))
           and v.__module__ == jax_mod.__name__}
    # profile_device's counterpart is device_profile (torch.profiler)
    renamed = {"profile_device": "device_profile"}
    missing = sorted(n for n in own if not hasattr(port_mod, renamed.get(n, n)))
    assert own and not missing, missing


def test_mae_and_max_abs_err_equal_jax():
    rng = np.random.default_rng(3)
    a, b = rng.integers(0, 256, (2, 40, 50), dtype=np.uint8)
    x, y = rng.standard_normal((2, 7, 9)).astype(np.float32)
    for u, v in ((a, b), (x, y), (a, a)):
        assert metrics.mae(u, v) == jax_metrics.mae(u, v)
        assert metrics.max_abs_err(u, v) == jax_metrics.max_abs_err(u, v)
    assert metrics.mae(a, a) == 0.0 and metrics.max_abs_err(a, b) > 0


def test_utils_exports_mae_and_timer_as_jax_does():
    from oclcomputervision_tpu import utils as jax_utils
    from oclcomputervision_tpu_torch import utils as port_utils

    assert set(jax_utils.__all__) <= set(port_utils.__all__)


def test_write_png_round_trips(tmp_path):
    import cv2

    from oclcomputervision_tpu_torch.utils import read_png, write_png

    rng = np.random.default_rng(4)
    rgb = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    for img in (rgb, rgb[..., 1]):
        path = str(tmp_path / f"x{img.ndim}.png")
        write_png(path, img)
        got = read_png(path)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, img)
        want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(want[..., ::-1] if img.ndim == 3 else want, img)
    with pytest.raises(ValueError):
        write_png(str(tmp_path / "bad.png"), rgb.astype(np.float32))
    with pytest.raises(ValueError):
        write_png(str(tmp_path / "bad.png"), np.zeros((4, 4, 4), np.uint8))


def test_timer_and_bench_op_on_the_cpu(tmp_path):
    import time

    from oclcomputervision_tpu_torch.utils import Timer
    from oclcomputervision_tpu_torch.utils.profiling import bench_op, device_trace

    t = Timer()
    assert t.mean_ms == 0.0
    for _ in range(3):
        with t.measure():
            time.sleep(0.002)
    assert t.count == 3 and t.total_ms >= 6.0 and t.mean_ms == t.total_ms / 3
    calls = []

    def fn(x):
        calls.append(x)
        time.sleep(0.002)

    ms = bench_op(fn, 1, warmup=1, iters=5)
    assert len(calls) == 6 and 2.0 <= ms < 1000.0
    with device_trace(str(tmp_path / "trace")):
        np.sort(np.random.default_rng(0).random(1000))
    with open(tmp_path / "trace" / "trace.pt.trace.json") as f:
        assert "traceEvents" in f.read()


def test_assets_and_psnr_equal_jax():
    from oclcomputervision_tpu.utils import assets as jax_assets

    assert ASSETS_DIR == jax_assets.ASSETS_DIR
    assert asset_path("lenna.png") == jax_assets.asset_path("lenna.png")
    rng = np.random.default_rng(0)
    a, b = rng.integers(0, 256, (2, 40, 50), dtype=np.uint8)
    assert metrics.psnr(a, b) == jax_metrics.psnr(a, b)
    assert metrics.psnr(a, a) == jax_metrics.psnr(a, a) == float("inf")


def _histeq_cases(rng):
    img = rng.integers(0, 256, (512, 512), dtype=np.uint8)
    img[:100] //= 4  # a dark band: unequal histograms per block
    hist = np.bincount(img.reshape(-1), minlength=256)
    maps = rng.uniform(0, 255, (2, 2, 256)).astype(np.float32)
    return {
        "calc_transfer_func": ((hist, 0.5, 0.05, 3.0), {}),
        "calc_transfer_func_f32": ((hist, 1.0, 0.02, 2.0), {"dtype": np.float32}),
        "clip_histogram": ((hist, 2.5), {}),
        "hist_grid": ((img,), {"tile": (64, 128)}),
        "histeq_global": ((img, 0.8, 0.01, 10.0), {}),
        "histeq_local_block": ((img.copy(),), {"blockshape": (128, 256), "clahe_clip": 2.0}),
        "apply_block_mappings": ((img[:300, :400], maps), {"blockshape": (256, 256)}),
    }


@pytest.mark.parametrize("case", list(_histeq_cases(np.random.default_rng(0))))
def test_oracle_histeq_copy_equals_jax(case):
    args, kwargs = _histeq_cases(np.random.default_rng(0))[case]
    fn = case.removesuffix("_f32")
    got = getattr(port_oracle_histeq, fn)(*args, **kwargs)
    want = getattr(jax_oracle_histeq, fn)(*args, **kwargs)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n_out, n_in", [(47, 23), (10, 31), (2048, 1024)])
def test_oracle_interpolation_copy_equals_jax(n_out, n_in, dtype):
    img = np.random.default_rng(n_in).integers(0, 256, (23, n_in, 3), dtype=np.uint8)
    for method in ("bilinear", "bicubic"):
        for mapping in ("align_corners", "hw_sampler", "half_pixel"):
            for got, want in zip(
                port_oracle_interp.axis_weights(n_out, n_in, method, dtype, mapping),
                jax_oracle_interp.axis_weights(n_out, n_in, method, dtype, mapping),
            ):
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)
            for x in (img, img[..., 0]):
                got = port_oracle_interp.resize_align_corners(x, (40, n_out), method, dtype, mapping)
                want = jax_oracle_interp.resize_align_corners(x, (40, n_out), method, dtype, mapping)
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(
                port_oracle_interp.resize_uint8(img, (40, n_out), method, mapping),
                jax_oracle_interp.resize_uint8(img, (40, n_out), method, mapping),
            )
    with pytest.raises(ValueError):
        port_oracle_interp.axis_weights(n_out, n_in, "nearest", dtype)


@pytest.mark.parametrize("scale", [2, 3])
def test_oracle_raisr_copy_equals_jax(scale):
    rng = np.random.default_rng(scale)
    port_cfg, jax_cfg = config.RaisrConfig(scale=scale), jax_config.RaisrConfig(scale=scale)
    for name in ("RGB2YUV", "YUV2RGB", "SOBEL_X", "SOBEL_Y", "CT_RING"):
        np.testing.assert_array_equal(getattr(port_oracle_raisr, name), getattr(jax_oracle_raisr, name))
    np.testing.assert_array_equal(port_oracle_raisr.gaussian2d(), jax_oracle_raisr.gaussian2d())
    img = rng.integers(0, 256, (20, 24, 3), dtype=np.uint8)
    up = port_oracle_raisr.cheap_upscale(img[..., 0] / 255.0, scale)
    np.testing.assert_array_equal(up, jax_oracle_raisr.cheap_upscale(img[..., 0] / 255.0, scale))
    np.testing.assert_array_equal(
        port_oracle_raisr.hash_image(up, port_cfg), jax_oracle_raisr.hash_image(up, jax_cfg)
    )
    np.testing.assert_array_equal(
        port_oracle_raisr.ct_blend_weights(up), jax_oracle_raisr.ct_blend_weights(up)
    )
    filters = rng.standard_normal((port_cfg.num_filters, 11, 11)) * 0.01
    for blend in ("none", "ct"):
        pc = dataclasses.replace(port_cfg, blend=blend)
        jc = dataclasses.replace(jax_cfg, blend=blend)
        np.testing.assert_array_equal(
            port_oracle_raisr.raisr_upsample(img, filters, pc),
            jax_oracle_raisr.raisr_upsample(img, filters, jc),
        )


@pytest.mark.parametrize("module", ["motion", "pyramid"])
def test_oracle_motion_and_pyramid_copies_are_letter_for_letter(module):
    port, jax_side = (
        os.path.join(REPO, pkg, "oracle", f"{module}.py")
        for pkg in ("oclcomputervision_tpu_torch", "oclcomputervision_tpu")
    )
    with open(port) as a, open(jax_side) as b:
        assert a.read() == b.read()


def test_oracle_interpolation_copy_is_letter_for_letter():
    port, jax_side = (
        os.path.join(REPO, pkg, "oracle", "interpolation.py")
        for pkg in ("oclcomputervision_tpu_torch", "oclcomputervision_tpu")
    )
    with open(port) as a, open(jax_side) as b:
        assert a.read() == b.read()


def test_oracle_motion_and_pyramid_copies_equal_jax():
    rng = np.random.default_rng(0)
    f0, f1 = rng.integers(0, 256, (2, 20, 28), dtype=np.uint8)
    seed = rng.uniform(-6, 6, (20, 28, 2)).astype(np.float32)
    assert port_oracle_motion.MEDIAN9_EXCHANGES == jax_oracle_motion.MEDIAN9_EXCHANGES
    assert port_oracle_motion.me_steps(15, 5) == jax_oracle_motion.me_steps(15, 5) == [5, 2, 1]
    for kw in ({}, {"seed": seed, "seed_mode": "fixed"}, {"costfn": "wsad_shipped"}):
        np.testing.assert_array_equal(
            port_oracle_motion.estimate_motion_vector(f0, f1, **kw),
            jax_oracle_motion.estimate_motion_vector(f0, f1, **kw),
        )
    for mode in ("shipped", "fixed"):
        np.testing.assert_array_equal(
            port_oracle_motion.upscale_mv(seed, 2, mode), jax_oracle_motion.upscale_mv(seed, 2, mode)
        )
    for got, want in zip(
        port_oracle_pyramid.gaussian_pyramid(f0, 2, 3), jax_oracle_pyramid.gaussian_pyramid(f0, 2, 3)
    ):
        np.testing.assert_array_equal(got, want)


def test_flo_and_epe_copies_equal_jax(tmp_path):
    from oclcomputervision_tpu.utils import flo as jax_flo
    from oclcomputervision_tpu_torch.utils import flo as port_flo

    gt = port_flo.read_flo(asset_path("flow10.flo"))
    assert gt.dtype == np.float32 and gt.shape == (480, 640, 2)
    np.testing.assert_array_equal(gt, jax_flo.read_flo(asset_path("flow10.flo")))
    flow = np.random.default_rng(1).standard_normal((7, 9, 2)).astype(np.float32)
    port_flo.write_flo(flow, str(tmp_path / "port.flo"))
    jax_flo.write_flo(flow, str(tmp_path / "jax.flo"))
    assert (tmp_path / "port.flo").read_bytes() == (tmp_path / "jax.flo").read_bytes()
    np.testing.assert_array_equal(port_flo.read_flo(str(tmp_path / "jax.flo")), flow)
    with pytest.raises(ValueError):
        port_flo.decode_flo(b"\x00" * 16)
    assert metrics.epe(flow, flow + 1.0) == jax_metrics.epe(flow, flow + 1.0)
    assert metrics.epe(np.zeros_like(gt), gt) == jax_metrics.epe(np.zeros_like(gt), gt)


def test_layout_guards_equal_jax():
    assert port_layout.MAX_CHANNELS == jax_layout.MAX_CHANNELS
    for shape, batched in (((5, 40, 3), None), ((5, 40, 3), True), ((5, 40, 56), False)):
        assert port_layout.rank3_is_batched(shape, batched, "op") == jax_layout.rank3_is_batched(
            shape, batched, "op"
        )
    for layout in (port_layout, jax_layout):
        with pytest.raises(ValueError, match="ambiguous"):
            layout.rank3_is_batched((5, 40, 56), None, "op")
        with pytest.raises(ValueError, match="channels-last"):
            layout.guard_batch_first((40, 56, 3), "op")


def test_libpng_luma_is_cv2_imread_grayscale():
    import cv2

    from oclcomputervision_tpu_torch.utils import load_gray

    for name in ("frame10.png", "frame11.png"):
        want = cv2.imread(asset_path(name), cv2.IMREAD_GRAYSCALE)
        np.testing.assert_array_equal(load_gray(name, libpng=True), want)
        # the rounded luma is cv2.cvtColor's; libpng truncates, so it is never above it
        d = load_gray(name).astype(int) - want
        assert d.min() == 0 and d.max() == 1


def test_as_device_defaults_to_the_card():
    # no card here: the default raises rather than returning the CPU
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        as_device(None)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        as_device("cuda")
    assert as_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        as_device("meta")
