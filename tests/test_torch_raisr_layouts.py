"""PyTorch port: the host-side tables the Hopper forms of the upscale, hash
and apply kernels read, on the CPU. The compact 2-tap upscale table must
reproduce the plain version bit for bit (which itself stays within 1 ULP of
the JAX twin); the hash's parameter struct must carry the plain version's
taps and quantizers; the padded filter bank must equal ``phase_rows`` on its
live part and be built once per bank."""

import ctypes
import dataclasses
import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oclcomputervision_tpu.ops import raisr as jax_raisr
from oclcomputervision_tpu.ops.pallas import raisr_pallas
from oclcomputervision_tpu.utils.config import RaisrConfig
from oclcomputervision_tpu_torch.kernels import raisr as kraisr
from oclcomputervision_tpu_torch.kernels import upscale as kupscale
from oclcomputervision_tpu_torch.ops import raisr as port

torch.set_num_threads(2)

SCALES = [2, 3, 4]
# smaller than one kernel tile, not a multiple of it, one pixel, one row
SIZES = [(20, 30), (100, 75), (1, 1), (2, 300)]


def _tables(h, w, cfg):
    geo = port.plane_geometry(h, w, cfg)
    rows = kupscale.compact_axis_table(
        h, cfg.scale, geo.hp, geo.hq, kupscale.TILE[0], kupscale.SPAN[0])
    cols = kupscale.compact_axis_table(
        w, cfg.scale, geo.hp, geo.wq, kupscale.TILE[1], kupscale.SPAN[1])
    return geo, rows, cols


def _upscale_from_tables(x, s, rows, cols):
    """The kernel's arithmetic in numpy f32: two separately rounded products
    and one sum per pass."""
    (ri, rw), (ci, cw) = rows, cols
    out = []
    for a in range(s):
        v = rw[0, a][:, None] * x[:, ri[0, a], :] + rw[1, a][:, None] * x[:, ri[1, a], :]
        for b in range(s):
            out.append(cw[0, b] * v[:, :, ci[0, b]] + cw[1, b] * v[:, :, ci[1, b]])
    return np.stack(out, axis=1)


@pytest.mark.parametrize("s", SCALES)
@pytest.mark.parametrize("h,w", SIZES)
def test_compact_upscale_table_equals_plain(s, h, w):
    cfg = RaisrConfig(scale=s)
    geo, rows, cols = _tables(h, w, cfg)
    x = np.random.default_rng(s * 1000 + h).random((2, h, w), np.float32)
    want = kupscale.upscale_planes(torch.from_numpy(x), cfg, geo.hq, geo.wq, geo.hp)
    got = _upscale_from_tables(x, s, rows, cols)
    assert got.dtype == np.float32
    # the whole plane, halo and padding columns included, bit for bit
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("s", SCALES)
def test_compact_upscale_table_layout(s):
    cfg = RaisrConfig(scale=s)
    for h, w in SIZES + [(1024, 1024)]:
        geo, rows, cols = _tables(h, w, cfg)
        for (idx, wgt), n_in, n_out, tile, span in (
            (rows, h, geo.hq, kupscale.TILE[0], kupscale.SPAN[0]),
            (cols, w, geo.wq, kupscale.TILE[1], kupscale.SPAN[1]),
        ):
            assert idx.shape == wgt.shape == (2, s, n_out)
            assert idx.dtype == np.int32 and wgt.dtype == np.float32
            assert idx.min() >= 0 and idx.max() <= n_in - 1
            # what the kernel's staging relies on
            assert (np.diff(idx, axis=2) >= 0).all() and (idx[0] <= idx[1]).all()
            assert (wgt >= 0).all() and (wgt[0] > 0).all()
            np.testing.assert_allclose(wgt.sum(0), 1.0, atol=1e-6)
            for i0 in range(0, n_out, tile):
                i1 = min(i0 + tile, n_out) - 1
                assert idx[1][:, i1].max() - idx[0][:, i0].min() < span


def test_compact_upscale_table_refuses_a_tile_it_cannot_stage():
    with pytest.raises(ValueError, match="reaches"):
        kupscale.compact_axis_table(100, 2, 3, 136, 16, 8)


@pytest.mark.parametrize("s", SCALES)
def test_plain_upscale_still_within_one_ulp_of_jax_on_small_tiles(s):
    # the sub-tile geometry the kernel is checked at on the card
    cfg = RaisrConfig(scale=s)
    h, w = 20, 30
    geo = port.plane_geometry(h, w, cfg)
    x = np.random.default_rng(s).random((1, h, w), np.float32)
    want = np.asarray(jax_raisr.upscale_planes(
        jnp.asarray(x), cfg, geo.h2p, geo.w2p, geo.hq, geo.wq, geo.hp))
    got = kupscale.upscale_planes(torch.from_numpy(x), cfg, geo.hq, geo.wq, geo.hp)
    assert np.abs(got.numpy() - want).max() <= 1.2e-7


def _filters(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        (rng.standard_normal((cfg.num_filters, 11, 11)) * 0.05).astype(np.float32))


@pytest.mark.parametrize("s", SCALES)
def test_bank_layout(s):
    cfg = RaisrConfig(scale=s)
    filters = _filters(cfg, s)
    bank, stride = kraisr._bank_rows(filters, cfg)
    live = kraisr.phase_rows(filters, cfg)
    assert stride == kraisr.BANK_ROW_STRIDE == 122
    assert (stride // 2) % 2 == 1  # an odd count of 32-bit words per row
    assert bank.dtype == torch.bfloat16 and bank.is_contiguous()
    assert tuple(bank.shape) == (s * s, 216, stride)
    assert tuple(live.shape) == (s * s, 216, 121)
    assert torch.equal(bank[..., :121], live)
    assert (bank[..., 121:] == 0).all()
    # row [t, k] is filter k * s*s + t
    flat = filters.reshape(-1, 121).to(torch.bfloat16)
    assert torch.equal(bank[1, 5, :121], flat[5 * s * s + 1])


def test_bank_is_built_once_per_bank():
    cfg = RaisrConfig()
    filters = _filters(cfg)
    bank, _ = kraisr._bank_rows(filters, cfg)
    again, _ = kraisr._bank_rows(filters, cfg)
    assert again is bank
    # an equal bank in another tensor is another bank
    other, _ = kraisr._bank_rows(filters.clone(), cfg)
    assert other is not bank and torch.equal(other, bank)


def test_bank_is_rebuilt_after_an_in_place_change():
    cfg = RaisrConfig()
    filters = _filters(cfg, 1)
    bank, _ = kraisr._bank_rows(filters, cfg)
    filters.mul_(2.0)
    rebuilt, _ = kraisr._bank_rows(filters, cfg)
    assert rebuilt is not bank
    assert torch.equal(rebuilt[..., :121], kraisr.phase_rows(filters, cfg))
    assert kraisr._bank_rows(filters, cfg)[0] is rebuilt


def test_bank_of_a_freed_tensor_is_not_reused():
    # a new tensor may land on the freed one's address with the same version
    cfg = RaisrConfig()
    filters = _filters(cfg, 2)
    key_ptr = filters.data_ptr()
    bank, _ = kraisr._bank_rows(filters, cfg)
    del filters
    gc.collect()
    for seed in range(3, 8):
        fresh = _filters(cfg, seed)
        got, _ = kraisr._bank_rows(fresh, cfg)
        assert torch.equal(got[..., :121], kraisr.phase_rows(fresh, cfg))
        if fresh.data_ptr() == key_ptr:
            assert got is not bank
    assert len(kraisr._BANKS) <= kraisr._BANKS_KEPT


@pytest.mark.parametrize("s", SCALES)
def test_hash_params_carry_the_plain_versions_taps_and_quantizers(s):
    cfg = RaisrConfig(scale=s)
    prm = kraisr.hash_params(cfg)
    # 9 taps, 4 + 4 quantizers, 3 ints: the layout of csrc/raisr_hash.cu's struct
    assert ctypes.sizeof(prm) == 4 * (9 + 4 + 4 + 3)
    assert np.array_equal(np.array(prm.k1, np.float32), port._blur_k1(cfg).astype(np.float32))
    sq, cq = np.array(prm.squant, np.float32), np.array(prm.cquant, np.float32)
    assert np.array_equal(sq[:2], np.float32(cfg.strength_quantizers))
    assert np.array_equal(cq[:2], np.float32(cfg.coherence_quantizers))
    assert np.isnan(sq[2:]).all() and np.isnan(cq[2:]).all()
    assert (prm.na, prm.ns, prm.nc) == (cfg.num_angle, cfg.num_strength, cfg.num_coherence)
    # comparing l1 against all four padded entries, as the kernel does,
    # gives the plain version's strength index
    a, b, d = torch.from_numpy(np.random.default_rng(s).random((3, 4096), np.float32) ** 3 * 1e-2)
    _, si, _ = kraisr._eigen_bucket(a, b, d, cfg)
    tr = a + d
    l1 = tr / 2.0 + torch.sqrt(torch.clamp(tr * tr / 4.0 - (a * d - b * b), min=0.0))
    assert np.array_equal((l1.numpy()[None] >= sq[:, None]).sum(0), si.numpy())
    assert len(np.unique(si.numpy())) == 3


@pytest.mark.parametrize("change", [
    {"gauss_len": 7}, {"scale": 1}, {"scale": 5},
    {"strength_quantizers": (1e-5, 1e-4, 1e-3, 1e-2, 1e-1)},
])
def test_hash_params_refuse_what_the_kernel_is_not_compiled_for(change):
    # the compiled form's struct refuses the config; the wrapper routes it to
    # the generic form, whose parameters carry the plain version's values
    cfg = dataclasses.replace(RaisrConfig(), **change)
    with pytest.raises(ValueError, match="generic form"):
        kraisr.hash_params(cfg)
    assert kraisr.hash_form(cfg) == "raisr_hash_generic"
    prm = kraisr.hash_params_generic(cfg)
    gl, nsq = cfg.gauss_len, len(cfg.strength_quantizers)
    assert prm.dtype == np.float32 and prm.shape == (gl + nsq + len(cfg.coherence_quantizers),)
    assert np.array_equal(prm[:gl], port._blur_k1(cfg).astype(np.float32))
    assert np.array_equal(prm[gl : gl + nsq], np.float32(cfg.strength_quantizers))
    assert np.array_equal(prm[gl + nsq :], np.float32(cfg.coherence_quantizers))


@pytest.mark.parametrize("change, hash_form, apply_form", [
    ({}, "raisr_hash", "raisr_apply"),
    ({"scale": 3}, "raisr_hash", "raisr_apply"),
    ({"scale": 4}, "raisr_hash", "raisr_apply"),
    ({"filter_len": 13}, "raisr_hash", "raisr_apply_generic"),
    ({"filter_len": 7, "gauss_len": 7}, "raisr_hash_generic", "raisr_apply_generic"),
    ({"scale": 5}, "raisr_hash_generic", "raisr_apply_generic"),
    ({"coherence_quantizers": (0.1, 0.2, 0.3, 0.4, 0.5)}, "raisr_hash_generic", "raisr_apply"),
    # 432 buckets: four resident x2 banks would take 421 KB of shared memory
    ({"num_strength": 6}, "raisr_hash", "raisr_apply_generic"),
])
def test_forms_follow_the_config(change, hash_form, apply_form):
    cfg = dataclasses.replace(RaisrConfig(), **change)
    assert kraisr.hash_form(cfg) == hash_form
    assert kraisr.apply_form(cfg, 128) == apply_form
    want_up = "upscale_planes" if cfg.scale in (2, 3, 4) else "upscale_planes_generic"
    assert kupscale.upscale_form(cfg.scale) == want_up
    if apply_form == "raisr_apply":  # a block's shared memory holds its banks
        assert kraisr.apply_smem(cfg.scale, 216) <= kraisr.APPLY_SMEM_LIMIT
    # a plane width that is not a multiple of 4 takes the generic apply
    assert kraisr.apply_form(cfg, 126) == "raisr_apply_generic"


def test_shipped_x2_apply_fills_but_fits_shared_memory():
    # csrc/raisr_apply.cu at x2: four phases' banks of 216 x 61 words and a
    # bf16 tile of 4 planes x 22 x 72, 223488 of the 232448 bytes a block may
    # take: 225 buckets still fit, 226 go to the generic form
    assert kraisr.apply_smem(2, 216) == 4 * 4 * 216 * 61 + 2 * 4 * 22 * 72 == 223488
    assert kraisr.apply_smem(2, 225) <= kraisr.APPLY_SMEM_LIMIT < kraisr.apply_smem(2, 226)


@pytest.mark.parametrize("fl", [7, 11, 13])
def test_split_bank_rows_hold_each_tap_once(fl):
    # csrc/raisr_apply_split.cu's bank: split k of row [t, b] holds taps
    # [k q, (k + 1) q) of phase_rows' row in odd_words(q) words, then zeros
    cfg = dataclasses.replace(RaisrConfig(), filter_len=fl)
    rng = np.random.default_rng(fl)
    filters = torch.from_numpy(rng.standard_normal((cfg.num_filters, fl, fl)).astype(np.float32))
    plan = kraisr.split_plan(2, fl, 216, 3)
    stride = 2 * kraisr.odd_words(plan.q)
    bank, got_stride = kraisr._bank_rows(filters, cfg, stride, plan.q)
    assert got_stride == stride and bank.shape == (plan.nsplit, 4, 216, stride)
    assert (stride // 2) % 2 == 1 and plan.q <= stride
    rows = kraisr.phase_rows(filters, cfg)
    live = [bank[k, ..., : min(plan.q, fl * fl - k * plan.q)] for k in range(plan.nsplit)]
    assert torch.equal(torch.cat(live, dim=-1), rows)
    for k, part in enumerate(live):
        assert not bank[k, ..., part.shape[-1] :].float().any()
    # the generic form's layout of the same bank is another cached entry
    whole = kraisr._bank_rows(filters, cfg, 2 * kraisr.generic_row_words(fl))[0]
    assert whole.shape == (4, 216, 2 * kraisr.generic_row_words(fl))
    assert kraisr._bank_rows(filters, cfg, stride, plan.q)[0] is bank


@pytest.mark.parametrize("wrapper", ["upscale", "hash", "apply"])
def test_wrappers_refuse_a_tensor_on_neither_cpu_nor_cuda(wrapper):
    # a CPU tensor takes the plain version; any other device than the card
    # raises, whatever the config (generic ones included)
    cfg = dataclasses.replace(RaisrConfig(), scale=5)
    geo = port.plane_geometry(20, 30, cfg)
    meta = torch.empty((1, 25, geo.hq, geo.wq), device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        if wrapper == "upscale":
            kupscale.upscale_planes_kernel(torch.empty((1, 20, 30), device="meta"), cfg,
                                           geo.hq, geo.wq, geo.hp)
        elif wrapper == "hash":
            kraisr.hash_planes_kernel(meta, cfg, geo.hp, geo.h2p, geo.w2p)
        else:
            kraisr.apply_filters_planes_kernel(
                meta, torch.empty((1, 25, geo.h2p, geo.w2p), dtype=torch.int32, device="meta"),
                torch.empty((cfg.num_filters, 11, 11), device="meta"), cfg)


# bucket counts from (angles, strengths, coherences): 27 to 432
BUCKETS = [(3, 3, 3), (8, 3, 3), (16, 3, 3), (24, 3, 3), (25, 3, 3), (24, 4, 3), (24, 6, 3)]


def _admitted(s, fl):
    """Whether the plane geometry takes scale s and filter length fl."""
    try:
        port.plane_geometry(64, 128, dataclasses.replace(RaisrConfig(), scale=s, filter_len=fl))
    except ValueError:
        return False
    return True


@pytest.mark.parametrize("s", [2, 3, 4, 5, 6])
def test_generic_apply_planner_fits_shared_memory(s):
    # csrc/raisr_apply_generic.cu: 1-4 resident phases (256 threads each)
    # whose banks, tap tables and tile fit a block, or none and the split form
    seen = set()
    for fl in range(1, 18):
        if not _admitted(s, fl):
            continue
        for na, ns, nc in BUCKETS:
            nbk = na * ns * nc
            p = kraisr.generic_apply_phases(s, fl, nbk)
            if p:
                assert 1 <= p <= min(kraisr.APPLY_MAX_PHASES, s * s)
                assert kraisr.generic_apply_smem(s, fl, nbk, p) <= kraisr.APPLY_SMEM_LIMIT
                # the sets of phases cover all s*s phases with the fewest blocks
                most = max(q for q in range(1, min(4, s * s) + 1)
                           if kraisr.generic_apply_smem(s, fl, nbk, q) <= kraisr.APPLY_SMEM_LIMIT)
                assert -(-(s * s) // p) == -(-(s * s) // most)
            else:
                assert kraisr.generic_apply_smem(s, fl, nbk, 1) > kraisr.APPLY_SMEM_LIMIT
                cfg = dataclasses.replace(RaisrConfig(), scale=s, filter_len=fl, num_angle=na,
                                          num_strength=ns, num_coherence=nc)
                assert kraisr.apply_form(cfg, 128) == "raisr_apply_split"
            seen.add(bool(p))
    assert True in seen


@pytest.mark.parametrize("change, form, phases", [
    ({"filter_len": 13}, "raisr_apply_generic", 2),
    ({"filter_len": 7, "gauss_len": 7, "num_strength": 6}, "raisr_apply_generic", 4),
    ({"scale": 5}, "raisr_apply_generic", 3),
    ({"scale": 6, "filter_len": 17}, "raisr_apply_generic", 1),
    # 145 words x 432 rows = 250,560 bytes: one phase's bank fits no block
    ({"filter_len": 17, "num_strength": 6}, "raisr_apply_split", 0),
    ({"filter_len": 16, "num_strength": 6}, "raisr_apply_split", 0),
    ({"filter_len": 15, "num_strength": 6}, "raisr_apply_generic", 1),
])
def test_apply_form_takes_the_split_form_exactly_when_a_bank_does_not_fit(change, form, phases):
    cfg = dataclasses.replace(RaisrConfig(), **change)
    nbk = kraisr._num_buckets(cfg)
    assert kraisr.apply_form(cfg, 128) == kraisr.apply_form(cfg, 126) == form
    assert kraisr.generic_apply_phases(cfg.scale, cfg.filter_len, nbk) == phases
    fits = kraisr.generic_apply_smem(cfg.scale, cfg.filter_len, nbk, 1) <= kraisr.APPLY_SMEM_LIMIT
    assert fits == (form == "raisr_apply_generic")


def test_generic_apply_split_boundary_in_buckets():
    # at x2 filter_len 17 the largest bank that still fits goes to the
    # resident-bank form, one bucket more to the split form
    words = kraisr.generic_row_words(17)
    fit = max(n for n in range(1, 500)
              if kraisr.generic_apply_smem(2, 17, n, 1) <= kraisr.APPLY_SMEM_LIMIT)
    assert words == 145 and 216 < fit < 432
    for n, form in ((fit, "raisr_apply_generic"), (fit + 1, "raisr_apply_split")):
        cfg = dataclasses.replace(RaisrConfig(), filter_len=17, num_angle=n, num_strength=1,
                                  num_coherence=1)
        assert kraisr.apply_form(cfg, 128) == form


# 27, 216, 432 and 1944 buckets
SPLIT_BUCKETS = [(3, 3, 3), (24, 3, 3), (24, 6, 3), (24, 9, 9)]


@pytest.mark.parametrize("s", [2, 3, 4, 5, 6])
def test_split_planner_covers_every_tap_once_and_fits(s):
    # csrc/raisr_apply_split.cu: the fewest splits of q consecutive taps (q
    # even) whose rows, tap table, plane list and tile let two blocks share
    # an SM, else the fewest that fit one block; every
    # tap of every phase lies in exactly one split, in order, each split's
    # record lists the planes its taps read, and every bucket row is in
    # every split (test_split_bank_rows_hold_each_tap_once)
    head = kraisr.SPLIT_HEAD
    for fl in range(1, 50):
        if not _admitted(s, fl):
            continue
        taps = kraisr.generic_tap_table(s, fl)
        ntap = fl * fl
        for na, ns, nc in SPLIT_BUCKETS:
            nbk = na * ns * nc
            plan = kraisr.split_plan(s, fl, nbk)
            q, nsplit, maxp = plan.q, plan.nsplit, plan.maxp
            assert q % 2 == 0 and (nsplit - 1) * q < ntap <= nsplit * q
            smem = kraisr.split_apply_smem(s, fl, nbk, q, maxp)
            assert smem <= kraisr.APPLY_SMEM_LIMIT
            if nsplit > 1:  # one split fewer does not fit, or not two blocks to an SM
                try:
                    fewer = kraisr.split_plan(s, fl, nbk, nsplit - 1)
                except ValueError:
                    fewer = None  # does not fit a block
                if fewer is not None:
                    assert smem <= kraisr.SPLIT_PAIR_SMEM < kraisr.split_apply_smem(
                        s, fl, nbk, fewer.q, fewer.maxp)
            rec = plan.table
            assert rec.dtype == np.int32 and rec.shape == (s * s, nsplit, head + maxp + 3 * q)
            first = np.arange(nsplit) * q
            assert (rec[..., 1] == first).all() and (rec[..., 2] == np.minimum(q, ntap - first)).all()
            assert 1 <= rec[..., 0].min() and rec[..., 0].max() == maxp <= min(q, s * s)
            for t in range(s * s):
                parts = []
                for k in range(nsplit):
                    npl, nq = rec[t, k, 0], rec[t, k, 2]
                    planes = rec[t, k, head : head + npl]
                    staged = rec[t, k, head + maxp : head + maxp + 3 * nq].reshape(nq, 3)
                    assert (np.diff(planes) > 0).all() and set(staged[:, 0]) == set(range(npl))
                    parts.append(np.column_stack([planes[staged[:, 0]], staged[:, 1:]]))
                assert np.array_equal(np.concatenate(parts), taps[t])


def test_split_form_takes_any_batch(monkeypatch):
    # the one-thread-per-pixel form it replaced refused nimg * s*s > 65535
    # (its grid's z); the split form's persistent blocks walk every tile of
    # any batch. The CUDA branch of the wrapper, on meta tensors, with the
    # launch recorded instead of made.
    cfg = dataclasses.replace(RaisrConfig(), filter_len=17, num_strength=6,
                              strength_quantizers=(1e-5, 1e-4, 1e-3, 1e-2, 1e-1))
    geo = port.plane_geometry(1, 1, cfg)
    nimg = 65535 // 4 + 1
    calls = []
    monkeypatch.setattr(kraisr, "require_cuda_tensor", lambda *args: None)
    monkeypatch.setattr(kraisr, "launch", lambda *args: calls.append(args))
    planes = torch.empty((nimg, 4, geo.hq, geo.wq), device="meta")
    buckets = torch.empty((1, 4, geo.h2p, geo.w2p), dtype=torch.int32, device="meta")
    filters = torch.empty((cfg.num_filters, 17, 17), device="meta")
    out = kraisr.apply_filters_planes_kernel(planes, buckets, filters, cfg)
    assert out.shape == (nimg, 4, geo.h2p, geo.w2p)
    ((kernel, entry, _, *args),) = calls
    assert (kernel, entry) == ("raisr_apply_split", "ocvk_raisr_apply_split")
    plan = kraisr.split_plan(2, 17, 432)
    assert args[5:7] == [nimg, 1] and args[5] * 4 > 65535
    assert args[-5:] == [432, kraisr.odd_words(plan.q), plan.nsplit, plan.q, plan.maxp]


@pytest.mark.parametrize("fl", [1, 2, 4, 7, 11, 13, 17])
def test_generic_bank_rows_have_an_odd_word_stride(fl):
    cfg = dataclasses.replace(RaisrConfig(), filter_len=fl)
    words = kraisr.generic_row_words(fl)
    assert words % 2 == 1 and fl * fl <= 2 * words <= fl * fl + 3
    if fl % 2:
        assert words == (fl * fl + 1) // 2
    rng = np.random.default_rng(fl)
    filters = torch.from_numpy(rng.standard_normal((cfg.num_filters, fl, fl)).astype(np.float32))
    bank, stride = kraisr._bank_rows(filters, cfg, 2 * words)
    assert stride == 2 * words and bank.shape == (4, 216, stride)
    assert torch.equal(bank[..., : fl * fl], kraisr.phase_rows(filters, cfg))
    assert not bank[..., fl * fl :].float().any()


@pytest.mark.parametrize("s", [2, 3, 4, 5, 6])
def test_generic_tap_table_is_the_plain_versions(s):
    # the JAX kernel's tables (raisr_pallas._tap_tables at its plane halo),
    # which the port's plain apply reads too
    for fl in range(1, 18):
        table = kraisr.generic_tap_table(s, fl)
        assert table.dtype == np.int32 and table.shape == (s * s, fl * fl, 3)
        hp = raisr_pallas.plane_halo(fl, s)
        assert port.plane_halo(fl, s) == hp
        for t in range(s * s):
            py, px = divmod(t, s)
            planes, offs = raisr_pallas._tap_tables(fl, s, py, px, hp)
            assert table[t, :, 0].tolist() == planes
            assert [(int(r) + hp, int(c) + hp) for r, c in table[t, :, 1:]] == offs
            assert port._tap_tables(fl, s, py, px, hp) == (planes, offs)
        # every offset stays inside the reach the kernel stages
        reach = -(-(fl // 2) // s)
        assert np.abs(table[..., 1:]).max() <= reach


@pytest.mark.parametrize("change", [
    {"gauss_len": 1}, {"gauss_len": 3}, {"gauss_len": 7}, {"gauss_len": 13, "scale": 3},
    {"scale": 5}, {"strength_quantizers": (1e-5, 1e-4, 1e-3, 1e-2, 1e-1), "num_strength": 6},
    {"coherence_quantizers": (), "num_coherence": 1},
])
def test_generic_hash_params_carry_taps_and_quantizers(change):
    # what csrc/raisr_hash_generic.cu stages once per block: the f32 taps of
    # _blur_k1, then the strength and the coherence quantizers
    cfg = dataclasses.replace(RaisrConfig(), **change)
    prm = kraisr.hash_params_generic(cfg)
    gl, nsq = cfg.gauss_len, len(cfg.strength_quantizers)
    k1 = jax_raisr._blur_k1(cfg)  # the JAX package's window, in f64
    assert np.array_equal(port._blur_k1(cfg), k1)
    assert prm.dtype == np.float32 and prm.shape == (gl + nsq + len(cfg.coherence_quantizers),)
    assert np.array_equal(prm[:gl], k1.astype(np.float32))
    assert np.array_equal(prm[:gl], prm[:gl][::-1])  # a symmetric window
    assert np.array_equal(prm[gl : gl + nsq], np.float32(cfg.strength_quantizers))
    assert np.array_equal(prm[gl + nsq :], np.float32(cfg.coherence_quantizers))


def _hash_admitted(s, gl):
    """Whether the plane geometry takes scale s and blur length gl."""
    try:
        port.plane_geometry(64, 128, dataclasses.replace(RaisrConfig(), scale=s, gauss_len=gl))
    except ValueError:
        return False
    return True


@pytest.mark.parametrize("s", [2, 3, 5, 6, 18, 19, 40, 122, 127, 129])
def test_generic_hash_refuses_exactly_what_its_strip_cannot_hold(s):
    # csrc/raisr_hash_generic.cu walks strips of 128 HR columns less the
    # blur's reach on each side: every admitted config with s + 2 (gl // 2)
    # <= 128 runs, every other one is refused before a launch
    taken, refused = 0, 0
    for gl in range(1, 6 * s + 4, 2):
        if not _hash_admitted(s, gl):
            continue
        cfg = dataclasses.replace(RaisrConfig(), scale=s, gauss_len=gl)
        if s + 2 * (gl // 2) <= kraisr.HASH_GENERIC_COLS:
            assert kraisr.hash_form(cfg) in ("raisr_hash", "raisr_hash_generic")
            taken += 1
        else:
            with pytest.raises(ValueError, match="generic hash"):
                kraisr.hash_form(cfg)
            refused += 1
    # the plane halo (at most 4 planes) bounds the blur at 3s: scales up to
    # 18 take every blur length it admits
    assert taken + refused > 0
    assert (refused > 0) == (s >= 19)
    assert (taken > 0) == (s <= 127)
