"""PyTorch port: colour RAISR with the census-transform blend
(``RaisrModel.load(..., blend='ct').upsample`` on RGB) against the
benchmark's plain reference of ``raisr_x2_rgb_ct``
(``benchmark_torch/reference/raisr_colour.py``).

On the CPU at 2 x 40 x 56 RGB: the luma of the cheap upscale, the hash's
buckets and the census weights bit for bit; the whole output within the
configuration's ``off_gt1_share`` limit with the shipped bank and with a
seeded random one; the control (one precision lower) outside it; the census
weight's correctly rounded value (C1); the ``ocv.raisr.csc`` and
``ocv.raisr.ct`` spans a colour call records, which a gray call does not.

On the card (marker ``cuda``, skipped without one): the spans' allocation
counter against the bytes reckoned from the shapes, and the census weights
the same bits as on the CPU. Run there with the repository's card command,
``python -m pytest -p no:cacheprovider -m cuda tests/``.
"""

import ast
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark_torch.configs import raisr_x2, raisr_x2_rgb_ct as config
from benchmark_torch.content import lenna_rgb
from benchmark_torch.reference import raisr as ref_raisr
from benchmark_torch.reference import raisr_colour as ref
from oclcomputervision_tpu_torch.kernels import raisr as kraisr
from oclcomputervision_tpu_torch.kernels import upscale as kupscale
from oclcomputervision_tpu_torch.models import RaisrModel
from oclcomputervision_tpu_torch.ops import raisr as oraisr
from oclcomputervision_tpu_torch.oracle import raisr as oracle_raisr
from oclcomputervision_tpu_torch.utils import tracing

torch.set_num_threads(2)

CPU = torch.device("cpu")
with open(os.path.join(os.path.dirname(config.__file__), "raisr_x2_rgb_ct.json")) as f:
    SPEC = json.load(f)
LIMIT = SPEC["limits"]["off_gt1_share"]
FRAME = (40, 56)
# the correctly rounded float32 of 5 / 6, the census weight at LCC = 3; a
# division by a Python scalar on CUDA, and the JAX package's jitted
# (8 - lcc) / 6 on the CPU, multiply by the reciprocal instead: 1062557014
FIVE_SIXTHS = 1062557013


def _frames(seed: int, n: int = 2) -> torch.Tensor:
    return lenna_rgb.make(torch.Generator().manual_seed(seed), n, *FRAME, CPU)


@pytest.fixture(scope="module")
def rgb():
    return _frames(23)


@pytest.fixture(scope="module")
def model():
    return raisr_x2.load_model(SPEC, CPU)


def _random_bank(cfg) -> np.ndarray:
    """N(0, 0.02) taps plus a unit centre tap, from a fixed seed."""
    fl = cfg.filter_len
    bank = np.random.default_rng(13).normal(0.0, 0.02, (cfg.num_filters, fl, fl))
    bank[:, fl // 2, fl // 2] += 1.0
    return bank.astype(np.float32)


def _port_stages(rgb, cfg):
    """The port's plain stages of a colour call, interleaved to the image:
    (Y of the cheap upscale, buckets, census weights), each [B, sH, sW]."""
    s = cfg.scale
    bsz, h, w, _ = rgb.shape
    geo = oraisr.plane_geometry(h, w, cfg)
    x01 = oraisr.true_div(rgb.to(torch.float32), 255.0)
    stacked = torch.cat([x01[..., c] for c in range(3)], dim=0)
    up = kupscale.upscale_planes(stacked, cfg, geo.hq, geo.wq, geo.hp)
    yuv = oraisr._csc_planes([up[c * bsz : (c + 1) * bsz] for c in range(3)],
                             oracle_raisr.RGB2YUV)
    hp, h2p, w2p = geo.hp, geo.h2p, geo.w2p
    y = yuv[0][:, :, hp : hp + h2p, hp : hp + w2p]
    buckets = kraisr.hash_planes(yuv[0], cfg, hp, h2p, w2p)
    wgt = oraisr._ct_blend_weight_planes(yuv[0], s, hp, h2p, w2p)
    return [oraisr.interleave_planes(t, s, s * h, s * w) for t in (y, buckets, wgt)]


def _ref_stages(rgb, r):
    x01 = ref_raisr.div(rgb.to(torch.float32), 255.0)
    y = ref.csc([ref.cheap_upscale(x01[..., c].contiguous(), r["scale"])
                 for c in range(3)], ref.RGB2YUV)[0]
    return [y, ref_raisr.hash_buckets(y, r), ref.ct_weights(y)]


@pytest.mark.parametrize("stage", ["luma", "buckets", "ct_weights"])
def test_each_stage_equals_the_reference_bit_for_bit(stage, rgb, model):
    k = ["luma", "buckets", "ct_weights"].index(stage)
    got = _port_stages(rgb, model.cfg)[k]
    want = _ref_stages(rgb, SPEC["raisr"])[k]
    assert got.shape == want.shape == (2, 80, 112)
    assert torch.equal(got.to(want.dtype), want)
    if stage == "ct_weights":  # every weight the blend can take, all present
        assert set(got.unique().tolist()) >= {0.0, 1.0} and len(got.unique()) >= 4


@pytest.mark.parametrize("bank", ["shipped", "random"])
def test_the_colour_ct_call_is_within_the_limit(bank, rgb, model):
    if bank == "random":
        model = RaisrModel.from_numpy(_random_bank(model.cfg), model.cfg, CPU)
    got = model.upsample(rgb)
    assert got.shape == (2, 80, 112, 3) and got.dtype == torch.uint8
    filters = model.filters.numpy()
    want = ref.upsample(rgb, filters, SPEC["raisr"])
    share = config.compare(SPEC, [got], [want])["off_gt1_share"]
    assert share <= LIMIT, share
    # the blend and the colour stages both act: neither a gray nor an
    # unblended call gives this output
    unblended = dataclasses.replace(model.cfg, blend="none")
    plain = RaisrModel.from_numpy(filters, unblended, CPU).upsample(rgb)
    assert not torch.equal(got, plain)


def test_the_control_is_outside_the_limit(rgb):
    want = config.reference(SPEC, rgb)
    got = config.control(SPEC, CPU)(rgb)
    assert config.compare(SPEC, [got], want)["off_gt1_share"] > LIMIT


@pytest.mark.parametrize("where", ["port_table", "reference"])
def test_the_census_weight_at_lcc_3_is_correctly_rounded(where):
    if where == "port_table":
        w = oraisr._ct_weight_table(CPU)
        assert w.dtype == torch.float32 and w.shape == (9,)
        assert w[[0, 1, 2, 8]].tolist() == [1.0, 1.0, 1.0, 0.0]
        five_sixths = w[3]
    else:
        five_sixths = torch.clamp(ref_raisr.div(torch.tensor([8.0 - 3.0]), 6.0), 0.0, 1.0)[0]
    assert int(five_sixths.view(torch.int32)) == FIVE_SIXTHS
    # the product with the reciprocal, which a CUDA division by a Python
    # scalar computes, is one ulp higher
    recip = np.float32(5.0) * (np.float32(1.0) / np.float32(6.0))
    assert int(np.array(recip, np.float32).view(np.int32)) == FIVE_SIXTHS + 1


@pytest.mark.parametrize("module", [ref, ref_raisr], ids=["raisr_colour", "raisr"])
def test_the_reference_imports_no_jax_and_no_module_of_the_port(module):
    barred = {"jax", "jaxlib", "oclcomputervision_tpu", "oclcomputervision_tpu_torch"}
    with open(module.__file__) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert names and not {n.split(".")[0] for n in names} & barred, names


def _spans(model, img):
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        model.upsample(img)
    recs = tracing.records()
    tracing.reset()
    return recs


@pytest.mark.parametrize("case", ["rgb_ct", "rgb_none", "gray_ct", "gray_none"])
def test_the_colour_and_census_spans(case, rgb, model):
    colour, blend = case.split("_")
    cfg = dataclasses.replace(model.cfg, blend=blend)
    recs = _spans(RaisrModel(cfg, model.filters), rgb if colour == "rgb" else rgb[..., 1])
    names = [r.name for r in recs if r.parent == 0]
    want = ["ocv.raisr.in", "ocv.raisr.upscale"]
    want += ["ocv.raisr.csc"] if colour == "rgb" else []
    want += ["ocv.raisr.hash", "ocv.raisr.apply"]
    want += ["ocv.raisr.ct"] if blend == "ct" else []
    want += ["ocv.raisr.csc"] if colour == "rgb" else []
    assert names == want + ["ocv.raisr.out"]
    assert len(recs) == 1 + len(want) + 1  # no stage holds another
    for r in recs:  # the counter reads only on the card
        assert r.alloc_bytes is None


# --- on the card ------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the allocator counter and the card's division")
    return torch.device("cuda", 0)


def _alloc_reckoned(bsz: int, h: int, w: int, cfg) -> dict:
    """(bytes, allocations) of each counted span of a colour ``blend='ct'``
    call at [bsz, h, w, 3], from the shapes: the CSC's rows (per row 3
    products and 3 sums, the first onto Python's 0) over the planes with
    their halo, then over the filtered planes; per phase the 8 ring bits
    and their 8 changes (bool), the changes stacked, their uint8 sum (LCC),
    that widened to int64 and the weight looked up; then the stacked
    weights and per channel the blend's 4 tensors."""
    geo = oraisr.plane_geometry(h, w, cfg)
    ss = cfg.scale ** 2
    halo = bsz * ss * geo.hq * geo.wq * 4
    inner = bsz * ss * geo.h2p * geo.w2p * 4
    phase = bsz * geo.h2p * geo.w2p  # elements of one phase's map
    csc = (18 * halo + 18 * inner, 36)
    per_phase = (8 + 8 + 8 + 1 + 8 + 4) * phase
    ct = (ss * per_phase + inner + 3 * 4 * inner, ss * 20 + 1 + 12)
    return {"ocv.raisr.csc": csc, "ocv.raisr.ct": ct}


SLACK = 2 << 20  # the allocator hands out a cached block up to 2 MiB larger than asked


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 40, 56), (16, 1024, 1024)])
def test_the_counter_reads_the_bytes_of_the_shapes(card, model, monkeypatch, shape):
    monkeypatch.setattr(tracing, "SAMPLE_EVERY", 1)
    m = raisr_x2.load_model(SPEC, card)
    img = lenna_rgb.make(torch.Generator(card).manual_seed(5), *shape, card)
    m.upsample(img)  # the weight table and the blocks the allocator caches
    torch.cuda.synchronize(card)
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        m.upsample(img)
    torch.cuda.synchronize(card)
    got = {}
    for r in tracing.records():
        if r.name in ("ocv.raisr.csc", "ocv.raisr.ct"):
            got[r.name] = got.get(r.name, 0) + r.alloc_bytes
    tracing.reset()
    for name, (want, allocs) in _alloc_reckoned(*shape, m.cfg).items():
        assert want <= got[name] <= want + allocs * SLACK, (name, got[name], want)


@pytest.mark.cuda
def test_the_census_weights_are_the_same_bits_on_the_card(card, model, rgb):
    cfg = model.cfg
    geo = oraisr.plane_geometry(*FRAME, cfg)
    g = torch.Generator().manual_seed(7)
    # luma planes with flat regions (every LCC) and noise
    y = torch.randint(0, 4, (2, 4, geo.hq, geo.wq), generator=g).to(torch.float32) / 3
    args = (cfg.scale, geo.hp, geo.h2p, geo.w2p)
    cpu = oraisr._ct_blend_weight_planes(y, *args)
    dev = oraisr._ct_blend_weight_planes(y.to(card), *args).cpu()
    assert torch.equal(cpu.view(torch.int32), dev.view(torch.int32))
    assert int(oraisr._ct_weight_table(card)[3].view(torch.int32)) == FIVE_SIXTHS
    # the whole call's stages on the card, the plain versions, against the reference
    got = _port_stages(rgb.to(card), cfg)
    want = _ref_stages(rgb.to(card), SPEC["raisr"])
    assert torch.equal(got[2], want[2])
