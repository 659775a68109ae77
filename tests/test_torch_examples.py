"""PyTorch port: the example scripts of ``examples_torch/`` run headless on
the CPU (``--device cpu``) at small sizes, each in a child process whose
first lines make cv2 and PIL unimportable, as on a machine without them. The
runs start together once for the module; each test waits for its own.

They print what the JAX scripts print (``tests/test_examples.py``'s
checks where they apply), write what they say they write, leave out and
say what needs cv2, and never write into ``assets/``; a script run without
``--device`` on a machine with no card exits non-zero with
``require_cuda``'s message instead of running on the CPU.
"""

import hashlib
import os
import re
import subprocess
import sys

import pytest

from oclcomputervision_tpu_torch.utils import read_flo, read_png

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(ROOT, "assets")
TIMEOUT_S = 240
PRELUDE = "import sys, runpy; sys.modules['cv2'] = None; sys.modules['PIL'] = None; "
# train_banks.main on a 64^2 corpus: its corpus() is a module-level function
SMALL_CORPUS = (
    "from oclcomputervision_tpu_torch.utils import load_gray, load_image; "
    "g = runpy.run_path({script!r}); "
    "g['main'].__globals__['corpus'] = lambda: ("
    "[load_image('lenna.png')[200:264, 200:264], load_gray('frame10.png')[100:164, 300:364]], "
    "load_gray('lenna.png')[300:364, 300:364], 'a 64^2 corpus'); "
    "sys.argv = [{script!r}, *{args!r}]; g['main']()"
)


# train_banks.corpus() with no JPEG decoder: the PNG corpus and its VAL split
PNG_CORPUS = (
    "g = runpy.run_path({script!r}); train, val, what = g['corpus'](); print(what); "
    "print([tuple(t.shape) for t in train], tuple(val.shape))"
)


def _script(name):
    return os.path.join(ROOT, "examples_torch", f"{name}.py")


def _command(name, args, patched_corpus=False):
    script = _script(name)
    body = (SMALL_CORPUS.format(script=script, args=args) if patched_corpus else
            f"sys.argv = [{script!r}, *{args!r}]; runpy.run_path({script!r}, run_name='__main__')")
    return [sys.executable, "-c", PRELUDE + body]


def _assets_digest():
    digest = {}
    for name in sorted(os.listdir(ASSETS)):
        with open(os.path.join(ASSETS, name), "rb") as f:
            digest[name] = hashlib.sha256(f.read()).hexdigest()
    return digest


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start every run; ``runs(key)`` waits for one and returns
    (returncode, stdout, stderr, its directory)."""
    base = tmp_path_factory.mktemp("examples")
    cases = {
        "video": ("video_pipeline", ["--frames", "4", "--width", "320", "--height", "192"]),
        "me": ("me_demo", ["--levels", "2", "--method", "fast", "--refine", "none",
                           "--probe", "120", "200", "--outdir", "{dir}"]),
        "interp": ("interpolation_bench", ["--size", "128", "--loop", "2"]),
        "raisr": ("raisr_bench", ["--loop", "2", "--batch", "2"]),
        "histeq": ("histeq_demo", ["--out", "{dir}/panel.png"]),
        "histeq_local": ("histeq_demo", ["--local", "--out", "{dir}/panel.png"]),
        "report": ("train_banks", ["--report-only", "--scales", "2"]),
        "train": ("train_banks", ["--scales", "2", "--bank-dir", "{dir}"]),
    }
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=ROOT)
    digest = _assets_digest()
    procs = {}
    for key, (name, args) in cases.items():
        d = base / key
        d.mkdir()
        args = [a.replace("{dir}", str(d)) for a in args] + ["--device", "cpu"]
        procs[key] = (subprocess.Popen(_command(name, args, patched_corpus=key == "train"),
                                       cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True), d)
    procs["corpus"] = (subprocess.Popen(
        [sys.executable, "-c", PRELUDE + PNG_CORPUS.format(script=_script("train_banks"))],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), base)
    # the same script without --device: no card here
    procs["no_device"] = (subprocess.Popen(
        _command("video_pipeline", ["--frames", "2"]), cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), base)
    done = {}

    def result(key):
        if key not in done:
            proc, d = procs[key]
            try:
                out, err = proc.communicate(timeout=TIMEOUT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                out, err = proc.communicate()
            done[key] = (proc.returncode, out, err, d)
        return done[key]

    result.assets_digest = digest
    yield result
    for key in procs:
        result(key)


def _ok(runs, key):
    rc, out, err, d = runs(key)
    assert rc == 0, err[-3000:]
    return out, d


def test_video_pipeline(runs):
    out, _ = _ok(runs, "video")
    assert "4 frames of 320x192 on cpu" in out
    assert "values differ from the JAX script's" in out
    for mode in ("sustained", "streaming"):
        assert re.search(mode + r" \(.*\): [0-9.]+ ms/frame = [0-9.]+ fps", out), out


def test_me_demo_writes_flows_and_scores(runs):
    out, d = _ok(runs, "me")
    assert "EPE" in out and "layer 1" in out
    for lv, shape in ((0, (240, 320, 2)), (1, (480, 640, 2))):
        assert read_flo(str(d / f"layer{lv}.flo")).shape == shape
    # the overlay and the probe view need cv2: left out, and said so
    assert "cv2 is not installed: no layer PNGs, search overlay or probe view" in out
    assert not (d / "probe_120_200.png").exists()


def test_interpolation_bench_protocol(runs):
    out, _ = _ok(runs, "interp")
    assert "the port's bicubic resize of lenna" in out
    for method in ("bilinear", "bicubic"):
        assert f"{method}: cpu took" in out
        assert f"{method}: cv2 took" not in out
    vals = [float(v) for v in re.findall(r"PSNR vs oracle: ([0-9.]+|inf)", out)]
    assert len(vals) == 2 and min(vals) > 50


def test_raisr_bench(runs):
    out, _ = _ok(runs, "raisr")
    assert re.search(r"RAISR 2x single image: [0-9.]+ ms/img wall = [0-9]+ MP out/s", out)
    assert re.search(r"RAISR 2x batch-2: [0-9.]+ ms/img wall", out)
    m = re.search(r"PSNR vs HR: bilinear ([0-9.]+)  bicubic ([0-9.]+)  raisr ([0-9.]+)", out)
    assert m, out
    bil, bic, ra = (float(v) for v in m.groups())
    assert ra > bic > bil


@pytest.mark.parametrize("key", ["histeq", "histeq_local"])
def test_histeq_demo_writes_panel(runs, key):
    out, d = _ok(runs, key)
    assert "no decoder for under_exposure.jpg" in out and "no cv2 CLAHE panel" in out
    mode = "local" if key.endswith("local") else "global"
    assert f"ours ({mode}) on cpu" in out
    panel = read_png(str(d / "panel.png"))
    # original | ours over their histogram strips: lenna 512^2 without cv2
    assert panel.shape == (512 + 120, 2 * 512, 3)


def test_train_banks_report_only(runs):
    out, _ = _ok(runs, "report")
    m = re.search(r"x2: frame11 PSNR raisr ([0-9.]+) bicubic ([0-9.]+)", out)
    assert m, out
    assert float(m.group(1)) > float(m.group(2))


def test_train_banks_writes_its_bank_dir_not_assets(runs):
    out, d = _ok(runs, "train")
    assert "corpus: a 64^2 corpus" in out
    assert len(re.findall(r"x2 ridge=[0-9.]+: val PSNR [0-9.]+", out)) == 6
    bank = d / "raisr_filters_x2.npz"
    assert bank.exists() and f"-> {bank}" in out
    # every run has ended: none wrote into assets/
    for key in ("video", "me", "interp", "raisr", "histeq", "histeq_local", "report"):
        runs(key)
    assert _assets_digest() == runs.assets_digest


def test_train_banks_png_corpus_without_a_jpeg_decoder(runs):
    out, _ = _ok(runs, "corpus")
    assert "no JPEG decoder: under_exposure.jpg left out" in out
    # lenna's left 60 % (307 of 512 columns) and frame10, a pyr_down of each
    # one's luma; VAL lenna's other 205 columns
    assert ("[(512, 307, 3), (480, 640, 3), (256, 153), (240, 320)] (512, 205)"
            in out), out


def test_no_card_no_fallback(runs):
    rc, out, err, _ = runs("no_device")
    assert rc != 0
    assert "torch.cuda.is_available() is False" in err
    assert "frames of" not in out
