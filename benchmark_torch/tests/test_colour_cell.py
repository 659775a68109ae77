"""The parts of ``raisr_x2_rgb_ct.batch16`` on the CPU: its colour content,
its counts of a colour call, and the readers of the program's allocation
counter (``raisr_csc_gb.batch``, ``raisr_ct_gb.batch``) on a hand-built
trace and record."""

import hashlib

import numpy as np
import pytest
import torch

from benchmark_torch.common import counts as cnt
from benchmark_torch.common import program, trace
from benchmark_torch.common.harness import Run, find_cell, load_benchmark, load_reader
from benchmark_torch.common.modules import load_content
from benchmark_torch.common.traffic import Window
from oclcomputervision_tpu_torch.utils.tracing import Span

CELL = "raisr_x2_rgb_ct.batch16"
RGB = load_content("lenna_rgb")
CPU = torch.device("cpu")
SEED = 3_141_592_653
LENNA_RGB_SHA256 = "01f8ff0e23a809255ae52a9857a7aeb0f89d92610205fef29c36c3d359ac3339"


def test_the_stored_image_is_pinned():
    # assets/lenna.png as the port's PNG reader decoded it, held by its digest
    stored = RGB.lenna_rgb()
    assert stored.dtype == np.uint8 and stored.shape == (512, 512, 3) and RGB.PLANES == 3
    assert hashlib.sha256(np.ascontiguousarray(stored).tobytes()).hexdigest() == LENNA_RGB_SHA256


def test_frames_are_rolled_tiles_with_noise_per_sample():
    gen = lambda: torch.Generator().manual_seed(SEED % (1 << 64))
    x = RGB.make(gen(), 3, 600, 700, CPU)
    assert x.dtype == torch.uint8 and tuple(x.shape) == (3, 600, 700, 3)
    assert torch.equal(x, RGB.make(gen(), 3, 600, 700, CPU))  # the seed gives the frames
    shifts = torch.randint(0, 512, (3, 2), generator=gen())  # the generator's first draw
    base = torch.from_numpy(RGB.lenna_rgb()).to(torch.int16)
    tile = base[torch.arange(600) % 512][:, torch.arange(700) % 512]
    rolled = torch.stack([torch.roll(tile, (int(r), int(c)), (0, 1)) for r, c in shifts])
    noise = x.to(torch.int16) - rolled
    inside = (rolled >= 8) & (rolled <= 247)  # where no clamp cuts the noise
    values, counts = noise[inside].unique(return_counts=True)
    assert values.tolist() == list(range(-8, 9))
    assert float((counts / counts.sum() - 1 / 17).abs().max()) < 0.005
    # each sample its own draw: two channels of a pixel agree about 1 / 17 of the time
    both = inside[..., 0] & inside[..., 1]
    same = (noise[..., 0] == noise[..., 1])[both].to(torch.float64).mean()
    assert abs(float(same) - 1 / 17) < 0.005


def test_the_colour_counts_read_buckets_and_bank_once():
    cell = find_cell(load_benchmark(), CELL)
    r, (h, w) = cell.spec["raisr"], cell.mix["frame"]
    got = cell.config.counts(cell.spec, 16, (h, w))
    gray = cnt.raisr_stages(r, 16, h, w)
    h2p, w2p, _, hq, wq = cnt.plane_geometry(h, w, r)
    planes, maps = 16 * 4 * hq * wq * 4, 16 * 4 * h2p * w2p * 4
    bank = 864 * 121 * 4
    assert got["kernels"]["raisr_apply"] == (3 * planes + maps + bank + 3 * maps,
                                             3 * gray["raisr_apply"][1])
    assert got["kernels"]["raisr_hash"] == gray["raisr_hash"]
    assert got["kernels"]["upscale_planes"] == cnt.raisr_stages(r, 48, h, w)["upscale_planes"]
    assert got["call"][0] == 3 * 16 * (h * w + 4 * h * w) + bank
    assert cell.config.out_pixels(cell.spec, (h, w)) == 4 * h * w  # pixels, not samples


def _span(name, call, t0, t1, parent=None, alloc=None):
    r = Span(name)
    r.call, r.parent, r.t0, r.t1, r.alloc_bytes = call, parent, t0, t1, alloc
    return r


def _run():
    t = trace.Trace((10.0, 10.1), [("kernel", 10.0, 10.1)], [("window", 10.0, 10.1)], 9.5)
    return Run(find_cell(load_benchmark(), CELL), 3.0, Window(0.0, 0.1, 4), 16, 2048 * 2048,
               {}, frozenset(), trace=t)


RECORD = [
    _span("ocv.raisr", 0, 0.44, 0.4999),  # opened before the window: not counted
    _span("ocv.raisr.csc", 0, 0.45, 0.46, parent=0, alloc=7 * 10**9),
    _span("ocv.raisr", 16, 0.5, 0.58),
    _span("ocv.raisr.csc", 16, 0.51, 0.52, parent=2, alloc=5 * 10**9),
    _span("ocv.raisr.ct", 16, 0.52, 0.53, parent=2, alloc=6 * 10**9),
    _span("ocv.raisr.csc", 16, 0.53, 0.54, parent=2, alloc=4 * 10**9),
    _span("ocv.raisr", 32, 0.585, 0.6),
    _span("ocv.raisr.csc", 32, 0.586, 0.59, parent=6, alloc=9 * 10**9),
    _span("ocv.raisr.csc", 32, 0.59, 0.595, parent=6, alloc=3 * 10**9),
]


@pytest.mark.parametrize("metric, record, want", [
    ("raisr_csc_gb.batch", RECORD, (5 + 4 + 9 + 3) / 2),  # per sampled call of the window
    ("raisr_ct_gb.batch", RECORD, 6 / 2),
    ("raisr_ct_gb.batch", RECORD[:4], None),  # no such span
    ("raisr_csc_gb.batch", [], None),  # an empty record
    # spans without a reading: the CPU, or a program without the counter
    ("raisr_csc_gb.batch", [_span("ocv.raisr", 16, 0.5, 0.58),
                            _span("ocv.raisr.csc", 16, 0.51, 0.52, parent=0)], None),
])
def test_the_counter_readers(monkeypatch, metric, record, want):
    monkeypatch.setattr(program, "records", lambda: record)
    got = load_reader(metric)(_run())
    assert got == (want if want is None else pytest.approx(want))
