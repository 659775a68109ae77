#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths once on one NVIDIA GPU: RAISR x2
inference (and RAISR at configs outside the compiled kernels' domain),
global and local-block histogram equalization, pyramidal block-matching
motion estimation, resize, RAISR 'shipped', the RAISR trainer,
EnhancePipeline, the compat API, the image-domain RAISR ops, the sharded
paths on torch.distributed and the example scripts.

    python3 chip_smoke.py [--seed 0]

Run from the repository root on a machine with one CUDA card. Phases (any
failure raises, and the script exits non-zero without the result line):

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. build the hand-written kernels from ``kernels/csrc`` with nvcc;
3. each RAISR kernel against its plain PyTorch version on the card, at the
   bench geometry (1024x1024 LR -> 2048x2048 HR, x2) with a batch of 2, and
   with the x3 and x4 banks on one 256x256 image; the hash on uniformly
   random, ramp and constant content at the bench geometry (batch of 2; the
   constant image must give bucket 0 wherever the hash window lies inside
   it); then the upscale, hash and apply
   kernels at x2, x3 and x4 on geometries their tiles do not divide (LR
   100x75; 37x100 planes in 45x108 of LR 13x21, which no image gives) or
   that are smaller than one tile (20x30), with the count of differing hash
   buckets printed for every case, the upscale over the
   whole plane (halo and padding columns included), the apply with three
   channels over one bucket map and with bucket maps that are the hash's
   own, one bucket everywhere, uniformly random, and random with entries -1
   and 216, which must give 0; and at x2 on phase 8's row bands (a 2048^2
   LR image in 4 bands of 512 rows and 8 of each neighbour's, zeros beyond
   the image), the upscale at the image's coordinates;
3b. each histeq kernel against its plain version, which it must equal: on
   random, natural (lenna tiled, rolled, +-8 noise) and constant batches at
   bench.py's geometries (hist256 and apply_lut on 256x768x1280, hist_tiles
   and blend_blocks on 64x768x1280 at 256x256 blocks), on a 3x101x77 batch
   and on a row that starts one byte past a 16-byte boundary; and at phase
   8's geometries: hist256 on a rank's 1080 rows of an 8K frame and
   apply_lut on them as one row, hist_tiles on a rank's 1024 rows of a
   4096x8192 image, and blend_blocks on 4096x8192 and on bands of it with
   their row origin (each rank's 1024 rows, a band from -128, one from row
   77, one past the bottom; the image's LUTs and random ones), each band
   also equal to the whole image's blend on its rows;
3c. each motion-estimation kernel against its plain version, which it must
   equal: the exact search unseeded (SAD and SSD; 2 noisy VGA pairs, a
   3x101x77 batch, the 9/3 and 11/5 geometries) and seeded (seeds in +-6,
   +-29 and one that saturates the bound 32, whose RuntimeWarning is
   expected; both seed modes; no clamp; +-200 on 2 % of the pixels with no
   bound, beyond any staged window), the fast iteration unseeded and
   seeded (residual and per-round gather forms), and the fast search's
   round kernel alone at 15/5, 9/3, 11/5, 21/17 and 35/31 on widths that
   put column w - 2 on either side of its tile and warp edges, on frames
   narrower and shorter than a tile and a patch, and SSD on frames of 0
   against 255; the median kernel alone on the same shapes and on frames 1
   pixel wide or tall, states in +-6 and +-2^20; and phase 8's bands of a
   2160x3840 pair: the fast iteration on each rank's rows inside the image
   with 17 of each neighbour's (557 and 574 rows), the exact search on its
   rows with 10 of each neighbour's (560 rows, zeros beyond the image);
3d. the RAISR kernels at configs outside the compiled forms' domain (x2
   with filter_len 7, gauss_len 7 and 5 strength quantizers; x2 with
   filter_len 13; x5; x2 with filter_len 17 and 5 strength quantizers,
   and x3 with filter_len 25 and the same buckets, whose banks fit no
   block's shared memory), banks made from the seed: the generic forms
   (upscale_planes_generic, raisr_hash_generic, raisr_apply_generic,
   raisr_apply_split) against their plain versions on 4 lenna images of
   256^2, LR 20x30 and 100x75, and LR 13x21 on 37x102 planes (a width that
   is not a multiple of 4), the apply on the hash's buckets, the first and
   the last bucket everywhere, uniformly random buckets and random ones
   with -1 and past-the-last holes; the apply forms must equal their plain
   versions bit for bit, the hash's differing buckets are printed; x3
   filter_len 25 also on 2 lenna images of 1024^2; the hash also at the
   blur lengths no config above runs (3 and 15 on its run-time path, 5, 11
   and 13 compiled in); the generic and the split apply's shared-memory
   sizes in Python (which chooses the form) must equal their .cu's over
   scales 2-6, filter_len 1-17 (the split: 1-25), 27-1944 buckets, and 1-4
   phases (the split: its tap counts and plane counts);
4. RAISR end to end through ``RaisrModel.load(...).upsample``: a
   16x1024x1024 uint8 batch (each RAISR kernel's launch count must rise
   during it, no generic form's) and one RGB image (lenna 512^2 -> 1024^2,
   held against the plain path); then blend='ct' on two of the batch's
   images and a BGRA lenna (alpha from the seed) through the kernels, each
   held against the plain path;
4d. one ``RaisrModel(cfg, bank).upsample`` per generic config on 2 lenna
   images of 256^2: it must launch the generic forms its config needs and
   agree with the plain path;
4b. histeq end to end through ``ops``: ``histeq_global`` on 256x768x1280,
   ``histeq_local_block(x, 0.5, 0.05, 3.0, (256, 256))`` on 64x768x1280
   with clahe_clip 0 and 2, and ``apply_block_mappings`` on 2x880x1400 with
   a 3x5 LUT grid (blocks that do not divide the image); each path's
   kernels' launch counts must rise during it, its output must equal the
   plain path's, and one natural image is held against the numpy oracle;
4c. motion estimation end to end through ``ops.estimate_motion_pyramid`` on
   the Middlebury pair (frame10/frame11, 480x640), 3 levels, smooth 9: the
   exact and the hybrid (fast + seeded exact) schedules, both again with 12
   subpixel rounds, and both on a batch of 4 noisy pairs; each path's
   kernels' launch counts must rise during it, its flows must equal the plain
   path's, the pyramid levels must be within one level of the numpy oracle's
   and the coarsest level's exact search must equal the numpy oracle's;
5. quality on held-out frame11: RAISR PSNR above bilinear, and above 35 dB
   against the numpy oracle;
5c. motion quality: end-point error of the four schedules' finest level
   against flow10.flo, each within 0.02 px of the JAX package's value on the
   decode that value was taken on (libpng's truncated luma), and printed for
   the port's rounded luma;
6. RAISR timing with CUDA events (median of 5 after 2 warm-ups): output
   MP/s of the 16x1024^2 batch through the kernels and through the plain
   versions, a torch.profiler breakdown of the kernel path (device ms per
   kernel and the idle share), and at the batch's shapes each kernel's own
   device time (torch.profiler), its wrapper call's and its plain version's
   time (CUDA events), for the upscale the time of F.interpolate
   (align_corners=True), checked to give the same values, for the hash its
   time on uniformly random luma and for the apply its time on uniformly
   random buckets beside the bench images' own;
6d. each generic form's time at 4 x 256^2 (the upscale at x5, the hash at
   filter_len 7 / gauss_len 7, the apply at filter_len 13, the split apply
   at filter_len 17) beside its bound and plain version (and F.interpolate
   for the upscale), and every stage's time at each generic config;
6e. each generic config but x3 filter_len 25 (GENERIC_BENCH):
   ``RaisrModel.upsample`` at the bench geometry
   (16x1024^2 lenna, through the kernels only): output MP/s (CUDA events,
   median of 5 after 2 warm-ups) beside the shipped x2 model's, each
   stage's own device time beside its bound, the idle share and the peak
   device memory, and the shared-memory passes of the apply's filter-row
   loads on its buckets; then, at that geometry, the hash against its plain
   version on 2 of the images (differing buckets printed) and the apply on
   all 16, which must equal its plain version bit for bit;
6b. histeq timing, the same way: input MP/s of both ops through the
   kernels and the plain versions, their profiles, and each kernel's,
   plain version's and single PyTorch call's time at the bench shapes
   (each such call first checked equal to its kernel), each kernel also
   with L2 flushed before every call (apply_lut's row takes that time: the
   timing loop leaves part of its 503 MB in the 50 MB L2);
6c. motion timing: input MP/s of ``estimate_motion_vector`` exact on 8 VGA
   pairs and fast on 16, finest-level MP/s of the batched exact pyramid on
   4 pairs, wall ms of the single-pair exact and hybrid pyramids, each
   through the kernels and the plain versions, the pyramids' profiles, the
   time of ``median_filter_flow`` and ``upscale_mv``, each kernel's own
   time at the 4-pair finest level beside its bound (also with L2 flushed
   before every call), and the exact search kernel unseeded on 8 pairs
   beside its own bound;
7. resize (``ops.resize_uint8``, ``ops.resize``; the resize_sep kernel):
   bilinear and bicubic under the three mappings on gray lenna, RGB lenna
   and a 3x256x320 stack, up and down, uint8 and f32 out, float input, the
   enhance cell's 16x1440x2560 -> 1080x1920 bicubic and a
   ``_raisr_shipped`` band: each call one launch and equal bit for bit to
   the plain passes on the card tensor; against device="cpu" (uint8 equal
   or within one level on 99.99 %, float within 1e-4) and the numpy oracle
   (within one level); the kernel's time at the cell's shape and at
   bench.py's 16x1024^2 -> 2048^2 beside its bytes bound, the plain passes
   and F.interpolate (a yardstick, another function);
7b. RAISR fidelity='shipped' through ``RaisrModel.load(...).upsample`` on
   gray, RGB and BGRA lenna against device="cpu", one resize_sep launch;
7c. the RAISR trainer at RaisrConfig() (864 filters of 11x11) on
   train_corpus(), augment='starved', float32 matmuls at full precision:
   lenna's features through the upscale and hash kernels against the plain
   versions on the card (fidx agreement, patches within 1 f32 ULP,
   per-bucket G and r, counts), the upscale and hash launch counts during
   training, the time by stage (each stage run again alone, its bank
   equal to the trainer's bit for bit) and the G/r rate, and the frame11 x2 PSNR of
   the bank above bicubic and within 0.05 dB of the JAX package's bank on
   the same corpus (JAX_TRAINED_FRAME11_DB), the shipped bank's beside it;
7d. ``EnhancePipeline`` (global equalize, RAISR x2, bicubic resize to
   1080x1920, a 3-level pyramid) on 16x768x1280 lenna tiles: the histeq,
   RAISR and resize launch counts, 2 images against device="cpu" (the equalized
   stage equal, the output and levels within one level on 99.9 %), input
   MP/s, the device's idle share and each stage's time alone; then
   equalize='local' on 2 images, untimed;
7e. one call of each ``compat`` entry point on the card against its
   use_gpu=False or numpy oracle counterpart (histeq global and local,
   HistEq's three methods, Utility's three (the resize kernel), Raisr, the exact search with and
   without a seed, gaussian_pyramid, upscale_mv), each with the kernels it
   must launch;
7f. the image-domain and plane RAISR ops of ``ops.raisr`` (the JAX
   package's public names: ``upscale_planes`` and ``hash_planes`` through
   their kernels, ``hash_components``, ``hash_image``, ``pixel_type_map``,
   ``apply_filters``, ``apply_filters_fast``, ``ct_blend_weights``) on CUDA
   tensors against the same calls on CPU tensors at 2 x 256^2 LR, x2: the
   upscale within 1.2e-7, buckets agreeing on >= 0.9999, pixel types and
   census weights equal, the applies within 2e-5;
7g. the program's stage spans and ``syncs`` counter (``utils.tracing``) at
   the benchmark cells' shapes: ``RaisrModel.upsample`` on 16 x 1024^2 and
   ``EnhancePipeline`` (global equalize, RAISR x2, bicubic to 1080 x 1920, a
   3-level pyramid) on 16 x 720 x 1280, each called 2 x SAMPLE_EVERY times
   under torch.profiler, call SAMPLE_EVERY inside a span ``ocv.planted``
   that also reads one pixel back with ``.item()``: the record must hold
   the two sampled calls (0 and SAMPLE_EVERY) alone, and ``syncs`` read 1
   at ``ocv.raisr.in`` (RAISR), 1 at ``ocv.equalize`` and 1 at
   ``ocv.raisr.in`` (enhance) in each, and 1 at ``ocv.planted``; the
   benchmark's
   ``read_profile`` of the same profile must list no ``ocv.`` name among
   the device's operations. Then the tracer's traced host cost a call: the
   mean host ms inside a call, 2 calls queued, with the tracer against
   ``tracing.span`` patched to the no-op, in one profiled session,
   TRACE_LOOPS loops of TRACE_CALLS calls each way in turns, each way first
   on every other loop;
8. the sharded paths of ``oclcomputervision_tpu_torch.parallel`` on
   ``torch.distributed``, each at full size: global histeq on a 4320x7680
   frame, local histeq on 4096x8192 at 256^2 blocks (clahe_clip 0 and 2),
   fast and exact motion (15/5) on a 2160x3840 pair of frame10/11 tiles
   with noise, RAISR x2 (the shipped bank, halo 8) on a 2048^2 LR image,
   with fidelity='full' and 'shipped' (the bilinear upscale alone, which
   must launch the resize kernel), ``raisr_train_step`` (RaisrConfig(), a (2, 2)
   dp x tp mesh) on phase 7c's corpus through the trainer's features, and
   ``EnhancePipeline.sharded`` on phase 7d's stack; first on 4 gloo ranks
   sharing the card (``parallel/launch.py`` in a child process; NCCL
   refuses two ranks on one device), then on one NCCL rank with CUDA
   tensors. Each result must equal the single-device op on the card bit
   for bit (the train step's bank within atol 5e-3, rtol 1e-2 and its
   frame11 x2 PSNR within 0.01 dB), and every rank must launch the path's
   kernels; one line per path gives the wall ms on 4 ranks, on 1 rank and
   of the single-device op. The ranks' launches stand in the kernels line
   beside the main paths' (``sharded_launches``: per path, the 4 gloo
   ranks' together and the NCCL rank's apart);
9. each script of ``examples_torch/`` once on the card, as a child process
   with its default arguments (histeq_demo also with --local, me_demo also
   with --method fast, train_banks with --scales 2 and a temporary
   --bank-dir): each must exit 0 and print its lines; me_demo's .flo files
   must equal a direct ``estimate_motion_pyramid`` call on the card,
   interpolation_bench's PSNR against the oracle exceed 50 dB, raisr_bench's
   and train_banks' frame11 x2 PSNR exceed bicubic's. Their numbers (MP/s,
   fps, EPE, PSNR) are printed and join the JSON line's ``e2e["examples"]``.

Prints the per-kernel JSON line, then, as its last line,
``{"ok": true, "device": {...}}``. Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

UPSCALE_TOL = 1.2e-7  # <= 1 f32 ULP on [0, 1] (tests/test_pallas.py:305's bound)
HASH_AGREEMENT = 0.9999  # bucket agreement (tests/test_pallas.py:335's contract)
APPLY_TOL = 2e-5  # bf16 x bf16 products are exact: only summation order differs
ORACLE_PSNR = 35.0  # dB, the bound of tests/test_raisr.py:80
E2E_WITHIN_ONE = 0.999  # share of output pixels within one level, kernels vs plain
# upscale planes vs F.interpolate, which maps coordinates in f32 (src =
# scale * dst, ~1e-4 of a pixel off at 2048 wide) where the planes' weights
# come from f64: a quarter of one uint8 level (3.9e-3)
LIBRARY_UPSCALE_TOL = 1e-3
LR = 1024  # bench geometry: 1024^2 LR -> 2048^2 HR at x2
BATCH = 16
GLOBAL_SHAPE = (256, 768, 1280)  # bench.py's fused_histeq_global_throughput geometry
LOCAL_SHAPE = (64, 768, 1280)  # bench.py's histeq_local_block_throughput geometry
BLOCK = (256, 256)
# apply_block_mappings with the 3x5 LUT grid of a 768x1280 image on a larger
# image the blocks do not divide (the grid covers up to 896x1408)
MAPPED_SHAPE = (2, 880, 1400)
ME_GEOMETRY = (15, 5)  # search and patch size: steps 5, 2, 1 (me_pyramid.py:130)
ME_LEVELS, ME_SMOOTH, ME_SUBPIXEL = 3, 9, 12
# bench.py's batches of noisy Middlebury pairs: the exact search, the fast
# mode, the batched exact pyramid
ME_EXACT_BATCH, ME_FAST_BATCH, ME_PYRAMID_BATCH = 8, 16, 4
# finest-level end-point error on flow10.flo of the JAX package's four
# schedules (BENCH_r05.json), which the port must reproduce
EPE_TARGETS = {"exact": 3.441, "hybrid": 3.165, "exact+subpixel": 2.457,
               "hybrid+subpixel": 2.308}
EPE_TOL = 0.02
ME_SCHEDULES = {
    "exact": {"method": "exact"},
    "hybrid": {"method": "fast"},
    "exact+subpixel": {"method": "exact", "subpixel": ME_SUBPIXEL},
    "hybrid+subpixel": {"method": "fast", "subpixel": ME_SUBPIXEL},
}
HISTEQ_ORACLE_SHARE = 0.01  # global vs oracle: <= 1 level on < 1 % (tests/test_histeq.py:65-72)

# bounds: the card's published rates (NVIDIA H100 SXM data sheet, 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores; used for integer ALU work too
# operations per output element, counted from each kernel's arithmetic
OPS_PER_ELEM = {
    "upscale_planes": 12,  # 2 x 2 taps: 4 products and 4 sums per pass
    "raisr_hash": 150,  # Sobel 22, tensor products 3, 9x9 blur of 3 maps 102, eigen and buckets ~23
    "raisr_apply": 2 * 121,  # one multiply and one add per tap
    "upscale_planes_generic": 12,
    # the generic hash and apply: per config, hash_ops(cfg) and 2 fl^2
    "hist256": 1,  # one count per pixel
    "apply_lut": 0,  # a table load per pixel
    "hist_tiles": 1,
    "blend_blocks": 17,  # 2 ramps, 2 complements, 8 products, 3 sums, 2 clamps
    # at 15/5: 9 + 8 + 8 candidates (the centre's cost carries over between
    # rounds) of 25 taps, each a subtract, an absolute value and an add
    "me_exact": 25 * 25 * 3,
    # per launch, the box-sum form the function needs: 9 candidates x (2
    # differences and 2 adds of a vertical running sum, 3 adds of the
    # horizontal sum at patch 5, 1 compare) = 72, and the state update (the
    # tap-by-tap form counted 9 x 25 x 3 = 675)
    "me_fast_round": 75,
    "me_fast_median": 2 * 19 * 2,  # per launch: 2 planes, 19 exchanges of a min and a max
}
RAISR_KERNELS = ("upscale_planes", "raisr_hash", "raisr_apply")
GENERIC_KERNELS = ("upscale_planes_generic", "raisr_hash_generic", "raisr_apply_generic",
                   "raisr_apply_split")
QUANT5 = (1e-5, 1e-4, 1e-3, 1e-2, 1e-1)  # five strength quantizers: num_strength 6
# configs outside the compiled RAISR forms' domain, each with a bank made
# from the seed: (the fields that differ from RaisrConfig(), the generic
# forms it must launch)
GENERIC_CONFIGS = {
    "x2 filter_len 7, gauss_len 7, 5 strength quantizers": (
        {"filter_len": 7, "gauss_len": 7, "num_strength": 6, "strength_quantizers": QUANT5},
        ("raisr_hash_generic", "raisr_apply_generic")),
    "x2 filter_len 13": ({"filter_len": 13}, ("raisr_apply_generic",)),
    "x5": ({"scale": 5}, ("upscale_planes_generic", "raisr_hash_generic",
                          "raisr_apply_generic")),
    # 432 rows of 145 words: one phase's bank (250,560 bytes) fits no block;
    # the split form cuts it in two
    "x2 filter_len 17, 5 strength quantizers": (
        {"filter_len": 17, "num_strength": 6, "strength_quantizers": QUANT5},
        ("raisr_hash_generic", "raisr_apply_split")),
    # 432 rows of 313 words (540,864 bytes a phase): three splits; plane halo 4
    "x3 filter_len 25, 5 strength quantizers": (
        {"scale": 3, "filter_len": 25, "num_strength": 6, "strength_quantizers": QUANT5},
        ("raisr_hash_generic", "raisr_apply_split")),
}
# the configs phase 6e runs at the bench geometry
GENERIC_BENCH = ("x2 filter_len 7, gauss_len 7, 5 strength quantizers", "x2 filter_len 13", "x5",
                 "x2 filter_len 17, 5 strength quantizers")
# the config phase 3d also holds on 2 lenna images of 1024^2
GENERIC_LARGE = "x3 filter_len 25, 5 strength quantizers"
GENERIC_SHAPE = (4, 256, 256)  # LR batch the generic forms are checked and timed at
# LR batches besides it in phase 3d, each with the plane geometry (h2p, w2p,
# hq, wq) to run it at (None: the pipeline's own): random LR smaller than
# one tile, phase 3's 100 x 75, and 13 x 21 on 37 x 102 planes, which no
# image gives, whose width is not a multiple of 4 and which the apply's and
# the hash's tiles divide on neither axis
GENERIC_CASES = (((1, 20, 30), None), ((2, 100, 75), None), ((1, 13, 21), (37, 102, 45, 112)))
# blur lengths of the generic hash that no config above runs, held against
# the plain version on random LR 100 x 75: 3 and 15, which it does not
# compile in (its run-time path), and 5, 11 and 13, which it does
GENERIC_HASH_BLURS = ({"gauss_len": 3}, {"scale": 3, "gauss_len": 15}, {"gauss_len": 5},
                      {"scale": 3, "gauss_len": 11}, {"scale": 5, "gauss_len": 13})
# which config each generic form is timed at
GENERIC_TIMED = {"upscale_planes_generic": "x5",
                 "raisr_hash_generic": "x2 filter_len 7, gauss_len 7, 5 strength quantizers",
                 "raisr_apply_generic": "x2 filter_len 13",
                 "raisr_apply_split": "x2 filter_len 17, 5 strength quantizers"}
GLOBAL_KERNELS = ("hist256", "apply_lut")
LOCAL_KERNELS = ("hist_tiles", "blend_blocks")
ME_KERNELS = ("me_exact", "me_fast_round", "me_fast_median")

KERNELS = {
    # name -> (source, replaced TPU kernel: file:line of its pl.pallas_call)
    "upscale_planes": (
        "oclcomputervision_tpu_torch/kernels/csrc/upscale_planes.cu",
        "oclcomputervision_tpu/ops/pallas/upscale_pallas.py:109",
    ),
    "raisr_hash": (
        "oclcomputervision_tpu_torch/kernels/csrc/raisr_hash.cu",
        "oclcomputervision_tpu/ops/pallas/raisr_pallas.py:826",
    ),
    "raisr_apply": (
        "oclcomputervision_tpu_torch/kernels/csrc/raisr_apply.cu",
        "oclcomputervision_tpu/ops/pallas/raisr_pallas.py:385",
    ),
    # the generic forms, for configs outside the compiled ones: the same TPU
    # kernels, which are written for any scale, blur and filter length
    "upscale_planes_generic": (
        "oclcomputervision_tpu_torch/kernels/csrc/upscale_planes.cu",
        "oclcomputervision_tpu/ops/pallas/upscale_pallas.py:109",
    ),
    "raisr_hash_generic": (
        "oclcomputervision_tpu_torch/kernels/csrc/raisr_hash_generic.cu",
        "oclcomputervision_tpu/ops/pallas/raisr_pallas.py:826",
    ),
    "raisr_apply_generic": (
        "oclcomputervision_tpu_torch/kernels/csrc/raisr_apply_generic.cu",
        "oclcomputervision_tpu/ops/pallas/raisr_pallas.py:385",
    ),
    "raisr_apply_split": (
        "oclcomputervision_tpu_torch/kernels/csrc/raisr_apply_split.cu",
        "oclcomputervision_tpu/ops/pallas/raisr_pallas.py:385",
    ),
    "hist256": (
        "oclcomputervision_tpu_torch/kernels/csrc/hist256.cu",
        "oclcomputervision_tpu/ops/pallas/histeq_pallas.py:78",
    ),
    "apply_lut": (
        "oclcomputervision_tpu_torch/kernels/csrc/apply_lut.cu",
        "oclcomputervision_tpu/ops/pallas/histeq_pallas.py:126",
    ),
    "hist_tiles": (
        "oclcomputervision_tpu_torch/kernels/csrc/hist_tiles.cu",
        "oclcomputervision_tpu/ops/pallas/localeq_pallas.py:256",
    ),
    "blend_blocks": (
        "oclcomputervision_tpu_torch/kernels/csrc/blend_blocks.cu",
        "oclcomputervision_tpu/ops/pallas/localeq_pallas.py:187 and "
        "oclcomputervision_tpu/ops/pallas/localeq_pallas.py:288",
    ),
    "me_exact": (
        "oclcomputervision_tpu_torch/kernels/csrc/me_exact.cu",
        "oclcomputervision_tpu/ops/pallas/me_pallas.py:251 and "
        "oclcomputervision_tpu/ops/pallas/me_pallas.py:781",
    ),
    # the fast iteration's TPU kernel is two CUDA kernels, one launch of each per round
    "me_fast_round": (
        "oclcomputervision_tpu_torch/kernels/csrc/me_fast_round.cu",
        "oclcomputervision_tpu/ops/pallas/me_fast_pallas.py:301",
    ),
    "me_fast_median": (
        "oclcomputervision_tpu_torch/kernels/csrc/me_fast_median.cu",
        "oclcomputervision_tpu/ops/pallas/me_fast_pallas.py:301",
    ),
    # no TPU kernel: the JAX resize is plain jnp, whose torch passes this replaces
    "resize_sep": (
        "oclcomputervision_tpu_torch/kernels/csrc/resize_sep.cu",
        "none (oclcomputervision_tpu/ops/interpolation.py is plain jnp)",
    ),
}


def bound(name: str, moved: int, elems: int, ops: int | None = None):
    """(least ms, "bytes" or "operations") for moving ``moved`` bytes once
    and doing ``ops`` (default OPS_PER_ELEM[name]) operations on each of
    ``elems`` elements."""
    by_bytes = moved / HBM_BYTES_PER_S * 1e3
    by_ops = (OPS_PER_ELEM[name] if ops is None else ops) * elems / F32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


L2_FLUSH_BYTES = 256 << 20  # written before each call of a cold-L2 timing: 5x the 50 MB L2


def kernel_ms(name: str, fn, cold_l2: bool = False) -> float:
    """Device ms per call of kernel ``name``'s own launches in ``fn()``, from
    torch.profiler over 5 calls after one warm-up. Unlike a CUDA-event window
    around the call, it leaves out the wrapper's host work (allocation, the
    ctypes call), which a kernel of tens of microseconds does not hide.
    ``cold_l2``: a 256 MB buffer is written before each call, so the kernel
    finds none of its inputs in L2, and meets the buffer's dirty lines there
    as its own last writes leave theirs behind."""
    import torch

    from oclcomputervision_tpu_torch.utils import device_profile

    if cold_l2:
        flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")

        def call():
            flush.fill_(1.0)
            return fn()
    else:
        call = fn
    per_kernel, _ = device_profile(call)
    hits = [ms for k, ms in per_kernel.items() if f"{name}_kernel" in k]
    if not hits:
        raise AssertionError(f"the profiler saw no {name} kernel in {sorted(per_kernel)}")
    return sum(hits)


def hash_ops(cfg) -> int:
    """Operations per HR pixel of the hash at ``cfg``: Sobel 22, the tensor
    products 3, two blur passes of 3 maps (gauss_len products and
    gauss_len - 1 sums each), the eigen analysis 19 and one compare per
    quantizer (150 at the shipped config, OPS_PER_ELEM["raisr_hash"])."""
    return (25 + 6 * (2 * cfg.gauss_len - 1) + 19 + len(cfg.strength_quantizers)
            + len(cfg.coherence_quantizers))


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def lenna_batch(rng, n: int, h: int, w: int | None = None):
    """bench.py's RAISR input: lenna luma tiled to h x w (square by
    default), then per image a random roll and additive noise in [-8, 8]."""
    import numpy as np

    from oclcomputervision_tpu_torch.utils import load_gray

    w = h if w is None else w
    base = load_gray("lenna.png")
    reps = -(-h // base.shape[0]), -(-w // base.shape[1])
    tile = np.tile(base, reps)[:h, :w]
    out = []
    for _ in range(n):
        sh = rng.integers(0, 512, 2)
        noisy = tile.astype(np.int16) + rng.integers(-8, 9, tile.shape)
        out.append(np.clip(np.roll(noisy, sh, (0, 1)), 0, 255).astype(np.uint8))
    return np.stack(out)


def train_corpus():
    """The PNG part of examples/train_banks.py's training corpus, through the
    port's own PNG reader: lenna and frame10 in RGB, and one pyr_down of each
    one's luma. under_exposure.jpg is left out, so that the corpus (and the
    JAX figure it is held to) needs no JPEG decoder."""
    from oclcomputervision_tpu_torch.oracle.pyramid import pyr_down
    from oclcomputervision_tpu_torch.utils import load_gray, load_image

    names = ("lenna.png", "frame10.png")
    return [load_image(n) for n in names] + [pyr_down(load_gray(n)) for n in names]


def degrade(hr, s: int):
    """examples/train_banks.py's degradation: crop to a multiple of s, then
    the s x s box mean rounded to uint8. Returns (hr, lr)."""
    import numpy as np

    h, w = (hr.shape[0] // s) * s, (hr.shape[1] // s) * s
    hr = hr[:h, :w]
    lr = hr.reshape(h // s, s, w // s, s).mean(axis=(1, 3)).round().astype(np.uint8)
    return hr, lr


def kernel_vs_plain(model, imgs, device):
    """Phase 3: each kernel and its plain version on the same inputs."""
    import torch

    from oclcomputervision_tpu_torch.kernels import raisr as kr
    from oclcomputervision_tpu_torch.kernels import upscale as ku
    from oclcomputervision_tpu_torch.ops.raisr import plane_geometry

    cfg = model.cfg
    x = torch.from_numpy(imgs).to(device)
    geo = plane_geometry(x.shape[1], x.shape[2], cfg)
    x01 = x.float() / torch.tensor(255.0, device=device)

    up_k = ku.upscale_planes_kernel(x01, cfg, geo.hq, geo.wq, geo.hp)
    up_p = ku.upscale_planes(x01, cfg, geo.hq, geo.wq, geo.hp)
    up_err = (up_k - up_p).abs().max().item()

    hb_k = kr.hash_planes_kernel(up_k, cfg, geo.hp, geo.h2p, geo.w2p)
    hb_p = kr.hash_planes(up_k, cfg, geo.hp, geo.h2p, geo.w2p)
    agree = (hb_k == hb_p).float().mean().item()
    ndiff = (hb_k != hb_p).sum().item()
    hash_err = (hb_k - hb_p).abs().max().item()

    # two channels stacked over one bucket map, as the colour path runs it
    planes = torch.cat([up_k, 0.5 * up_k]).contiguous()
    ap_k = kr.apply_filters_planes_kernel(planes, hb_k, model.filters, cfg)
    ap_p = kr.apply_filters_planes(planes, hb_k, model.filters, cfg)
    torch.cuda.synchronize()
    ap_err = (ap_k - ap_p).abs().max().item()

    tag = f"x{cfg.scale} {tuple(imgs.shape)}"
    print(f"{tag} upscale_planes: max|kernel - plain| = {up_err:.3e} "
          f"(tol {UPSCALE_TOL:.1e})")
    print(f"{tag} raisr_hash: bucket agreement = {agree:.7f} "
          f"(min {HASH_AGREEMENT}), {ndiff} pixels differ, max|diff| = {hash_err}")
    print(f"{tag} raisr_apply: max|kernel - plain| = {ap_err:.3e} (tol {APPLY_TOL:.1e})")
    if not up_err <= UPSCALE_TOL:
        raise AssertionError(f"upscale kernel off by {up_err}")
    if not agree >= HASH_AGREEMENT:
        raise AssertionError(f"hash kernel agreement {agree}")
    if not ap_err <= APPLY_TOL:
        raise AssertionError(f"apply kernel off by {ap_err}")
    return {
        "upscale_planes": {"max_abs_err": up_err},
        "raisr_hash": {"max_abs_err": hash_err, "agreement": agree, "differing": ndiff},
        "raisr_apply": {"max_abs_err": ap_err},
    }


def hash_agreement(tag, cfg, planes, hp, h2p, w2p):
    """The hash kernel against its plain version on these planes: prints the
    agreement and the count of differing pixels, raises below
    HASH_AGREEMENT; returns (agreement, differing, kernel's buckets)."""
    import torch

    from oclcomputervision_tpu_torch.kernels import raisr as kr

    got = kr.hash_planes_kernel(planes, cfg, hp, h2p, w2p)
    want = kr.hash_planes(planes, cfg, hp, h2p, w2p)
    torch.cuda.synchronize()
    agree = (got == want).float().mean().item()
    ndiff = (got != want).sum().item()
    print(f"x{cfg.scale} {tag} -> buckets {tuple(got.shape)}: raisr_hash agreement "
          f"{agree:.7f} (min {HASH_AGREEMENT}), {ndiff} pixels differ")
    if not agree >= HASH_AGREEMENT:
        raise AssertionError(f"hash kernel agreement {agree} on {tag}")
    return agree, ndiff, got


def hash_contents(model, rng, device):
    """Phase 3, the hash on three kinds of content at the bench geometry's
    batch of 2 (x2, 1024^2): uniform random luma in [0, 1), whose strong
    gradients put many pixels near a quantizer boundary; a linear ramp,
    fully coherent at one angle; and a constant image (planes equal to 0.3
    over the image, 0 in the halo), where every pixel whose Sobel-and-blur
    window lies inside the image has a zero tensor and must give bucket 0."""
    import torch

    from oclcomputervision_tpu_torch.kernels import upscale as ku
    from oclcomputervision_tpu_torch.ops.raisr import plane_geometry

    cfg = model.cfg
    s, n = cfg.scale, 2
    geo = plane_geometry(LR, LR, cfg)
    gen = torch.Generator(device=device).manual_seed(int(rng.integers(1 << 31)))
    yy = torch.arange(LR, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(LR, device=device, dtype=torch.float32)[None, :]
    lr = {"random": torch.rand((n, LR, LR), generator=gen, device=device),
          "ramp": (yy * 3e-4 + xx * 5e-4).expand(n, LR, LR).contiguous()}
    worst = 1.0
    for name, x01 in lr.items():
        up = ku.upscale_planes_kernel(x01, cfg, geo.hq, geo.wq, geo.hp)
        agree, _, _ = hash_agreement(f"{name} {tuple(x01.shape)}", cfg, up, geo.hp, geo.h2p,
                                     geo.w2p)
        worst = min(worst, agree)
    const = torch.zeros((n, s * s, geo.hq, geo.wq), device=device)
    const[..., geo.hp : geo.hp + geo.h2p, geo.hp : geo.hp + geo.w2p] = 0.3
    agree, _, got = hash_agreement(f"constant {(n, LR, LR)}", cfg, const, geo.hp, geo.h2p, geo.w2p)
    worst = min(worst, agree)
    # HR row s*i + a of plane a*s + b is inside when the blur (4) and Sobel (1)
    # reach stays in the s*h2p x s*w2p image; likewise for columns
    g = cfg.gauss_len // 2 + 1
    hr_r = s * torch.arange(geo.h2p, device=device)[None, :] + torch.arange(s, device=device)[:, None]
    hr_c = s * torch.arange(geo.w2p, device=device)[None, :] + torch.arange(s, device=device)[:, None]
    ok_r = (hr_r >= g) & (hr_r + g < s * geo.h2p)  # [a, i]
    ok_c = (hr_c >= g) & (hr_c + g < s * geo.w2p)  # [b, j]
    inside = (ok_r[:, None, :, None] & ok_c[None, :, None, :]).reshape(s * s, geo.h2p, geo.w2p)
    nonzero = (got[:, inside] != 0).sum().item()
    print(f"x{s} constant: {nonzero} of {n * inside.sum().item()} pixels inside the image "
          f"have a bucket other than 0")
    if nonzero:
        raise AssertionError("a constant image gave buckets other than 0 inside the image")
    return worst


# LR batches for tiling_cases, each with the plane geometry (h2p, w2p, hq, wq)
# to run it at: None is the pipeline's own, the last is one no image gives,
# whose sizes the kernels' tiles divide on neither axis
TILING_SHAPES = (((2, 100, 75), None), ((1, 20, 30), None), ((1, 13, 21), (37, 100, 45, 108)))


def tiling_cases(model, rng, device):
    """Phase 3, the cases a tiled kernel can get wrong: the upscale, hash and
    apply kernels against their plain versions on geometries that the
    kernels' tiles do not divide or that are smaller than one tile, the apply
    with three channels over one bucket map and on four kinds of bucket map."""
    import torch

    from oclcomputervision_tpu_torch.kernels import raisr as kr
    from oclcomputervision_tpu_torch.kernels import upscale as ku
    from oclcomputervision_tpu_torch.ops.raisr import plane_geometry

    cfg = model.cfg
    nbucket = cfg.num_angle * cfg.num_strength * cfg.num_coherence
    up_worst = ap_worst = 0.0
    hash_worst = 1.0
    for (n, h, w), planes_geo in TILING_SHAPES:
        x01 = torch.from_numpy(rng.random((n, h, w), dtype="float32")).to(device)
        geo = plane_geometry(h, w, cfg)
        h2p, w2p, hq, wq = planes_geo or (geo.h2p, geo.w2p, geo.hq, geo.wq)
        up_k = ku.upscale_planes_kernel(x01, cfg, hq, wq, geo.hp)
        up_p = ku.upscale_planes(x01, cfg, hq, wq, geo.hp)
        # over the whole [hq, wq] plane: halo rows and padding columns too
        up_err = (up_k - up_p).abs().max().item()
        gen = torch.Generator(device=device).manual_seed(int(rng.integers(1 << 31)))
        rand = torch.randint(0, nbucket, (n, cfg.scale**2, h2p, w2p), generator=gen,
                             device=device, dtype=torch.int32)
        holes = rand.clone()
        holes[..., ::7, ::5] = -1
        holes[..., 3::11, 1::3] = nbucket
        maps = {"one bucket": torch.full_like(rand, 17), "random": rand,
                "random with -1 and 216": holes}
        hash_agree, _, hb = hash_agreement(f"LR {(n, h, w)} planes {tuple(up_k.shape)}", cfg,
                                           up_k, geo.hp, h2p, w2p)
        hash_worst = min(hash_worst, hash_agree)
        if planes_geo is None:
            maps["hash"] = hb
        # three channels stacked over one bucket map, as the RGB path runs it
        planes = torch.cat([up_k, 0.5 * up_k, 0.25 * up_k]).contiguous()
        ap_errs = {}
        for name, bk in maps.items():
            ap_k = kr.apply_filters_planes_kernel(planes, bk, model.filters, cfg)
            ap_p = kr.apply_filters_planes(planes, bk, model.filters, cfg)
            torch.cuda.synchronize()
            ap_errs[name] = (ap_k - ap_p).abs().max().item()
            if name == "random" and not ap_k.abs().max().item() > 0:
                raise AssertionError("apply kernel wrote only zeros")
            if name.endswith("216"):
                out_of_range = ((bk < 0) | (bk >= nbucket)).repeat(3, 1, 1, 1)
                if ap_k[out_of_range].abs().max().item() != 0.0:
                    raise AssertionError("an out-of-range bucket did not give 0")
        up_worst = max(up_worst, up_err)
        ap_worst = max(ap_worst, *ap_errs.values())
        print(f"x{cfg.scale} LR {(n, h, w)} -> planes {tuple(up_k.shape)}: upscale_planes "
              f"max|kernel - plain| over the whole plane = {up_err:.3e}; raisr_apply on "
              f"{tuple(planes.shape)} over {tuple(rand.shape)} buckets: "
              + ", ".join(f"{k} {v:.3e}" for k, v in ap_errs.items()))
    if not up_worst <= UPSCALE_TOL:
        raise AssertionError(f"upscale kernel off by {up_worst}")
    if not ap_worst <= APPLY_TOL:
        raise AssertionError(f"apply kernel off by {ap_worst}")
    return {"upscale_planes": up_worst, "raisr_apply": ap_worst, "raisr_hash": hash_worst}


def band_cases(model, rng, device):
    """Phase 3, the RAISR kernels on phase 8's row bands: a SHARD_LR^2 LR
    image cut into SHARD_RANKS bands of its rows and SHARD_HALO rows of each
    neighbour's (zeros beyond the image), as ``raisr_upsample_sharded`` hands
    them to ``ops.raisr._raisr_band``: the upscale at the image's
    coordinates (row ``row0`` of an image of SHARD_LR rows), the hash and
    the apply on its planes, each against its plain version."""
    import torch

    from oclcomputervision_tpu_torch.kernels import raisr as kr
    from oclcomputervision_tpu_torch.kernels import upscale as ku
    from oclcomputervision_tpu_torch.ops.raisr import plane_geometry, true_div

    cfg = model.cfg
    lr = torch.from_numpy(lenna_batch(rng, 1, SHARD_LR)[0]).to(device)
    h_loc = SHARD_LR // SHARD_RANKS
    rows = h_loc + 2 * SHARD_HALO
    geo = plane_geometry(rows, SHARD_LR, cfg)
    up_worst = ap_worst = 0.0
    hash_worst = 1.0
    for r in range(SHARD_RANKS):
        row0 = r * h_loc - SHARD_HALO
        band = torch.zeros((1, rows, SHARD_LR), dtype=torch.uint8, device=device)
        lo, hi = max(0, row0), min(SHARD_LR, row0 + rows)
        band[0, lo - row0 : hi - row0] = lr[lo:hi]
        x01 = true_div(band.to(torch.float32), 255.0)
        up_k = ku.upscale_planes_kernel(x01, cfg, geo.hq, geo.wq, geo.hp, row0, SHARD_LR)
        up_p = ku.upscale_planes(x01, cfg, geo.hq, geo.wq, geo.hp, row0, SHARD_LR)
        up_err = (up_k - up_p).abs().max().item()
        tag = f"band {r} (LR rows {row0}:{row0 + rows} of {SHARD_LR})"
        agree, _, hb = hash_agreement(f"{tag} planes {tuple(up_k.shape)}", cfg, up_k, geo.hp,
                                      geo.h2p, geo.w2p)
        ap_k = kr.apply_filters_planes_kernel(up_k, hb, model.filters, cfg)
        ap_p = kr.apply_filters_planes(up_k, hb, model.filters, cfg)
        torch.cuda.synchronize()
        ap_err = (ap_k - ap_p).abs().max().item()
        print(f"x{cfg.scale} {tag}: upscale_planes max|kernel - plain| = {up_err:.3e}, "
              f"raisr_apply max|kernel - plain| = {ap_err:.3e}")
        up_worst, ap_worst = max(up_worst, up_err), max(ap_worst, ap_err)
        hash_worst = min(hash_worst, agree)
    if not up_worst <= UPSCALE_TOL:
        raise AssertionError(f"upscale kernel off by {up_worst} on a band")
    if not ap_worst <= APPLY_TOL:
        raise AssertionError(f"apply kernel off by {ap_worst} on a band")
    return {"upscale_planes": up_worst, "raisr_apply": ap_worst, "raisr_hash": hash_worst}


def bank_passes(buckets) -> float:
    """Mean shared-memory passes per filter-row load of ``raisr_apply``'s
    warps on these bucket planes [B, s*s, h2p, w2p]: a warp is 2 plane rows
    x 16 threads of 4 adjacent pixels and loads pixel k of every thread at
    once; rows (buckets) that are equal broadcast, different rows that are
    equal mod 32 share a bank and take a pass each. h2p must be even and w2p
    a multiple of 64, as every plane geometry is."""
    import torch

    b, ss, h, w = buckets.shape
    lanes = (buckets.reshape(b, ss, h // 2, 2, w // 64, 16, 4)
             .permute(0, 1, 2, 4, 6, 3, 5).reshape(-1, 32).long())
    v, _ = lanes.sort(dim=1)
    first = torch.ones_like(v, dtype=torch.bool)
    first[:, 1:] = v[:, 1:] != v[:, :-1]
    per_bank = torch.zeros_like(v).scatter_add_(1, v % 32, first.long())
    return per_bank.max(dim=1).values.float().mean().item()


def generic_models(rng, device):
    """A RaisrModel per GENERIC_CONFIGS entry, its bank made from the seed:
    the centre tap near 1 and small taps around it, as a trained bank."""
    import dataclasses

    import numpy as np
    import torch

    from oclcomputervision_tpu_torch.models.raisr import RaisrModel
    from oclcomputervision_tpu_torch.utils.config import RaisrConfig

    models = {}
    for name, (change, _) in GENERIC_CONFIGS.items():
        cfg = dataclasses.replace(RaisrConfig(), **change)
        fl = cfg.filter_len
        bank = rng.normal(0.0, 0.02, (cfg.num_filters, fl, fl)).astype(np.float32)
        bank[:, fl // 2, fl // 2] += 1.0
        models[name] = RaisrModel(cfg, torch.from_numpy(bank).to(device))
    return models


def generic_vs_plain(models, rng, device):
    """Phase 3d: the RAISR kernels at configs outside the compiled forms'
    domain against their plain versions, on lenna batches of GENERIC_SHAPE
    and the random LR batches of GENERIC_CASES (GENERIC_LARGE also on 2
    lenna images of LR^2): the upscale over the whole plane, the hash's
    agreement (differing buckets printed), the apply on the bucket maps of
    ``bucket_maps``, which must equal the plain version bit for bit (an
    out-of-range bucket gives 0). Each config's launches must go to the
    forms GENERIC_CONFIGS names. The hash also at the blur lengths of
    GENERIC_HASH_BLURS; the generic and split apply's shared-memory sizes
    in Python against their .cu's."""
    import dataclasses

    import torch

    from oclcomputervision_tpu_torch.kernels import _build
    from oclcomputervision_tpu_torch.kernels import raisr as kr
    from oclcomputervision_tpu_torch.kernels import upscale as ku
    from oclcomputervision_tpu_torch.ops.raisr import plane_geometry
    from oclcomputervision_tpu_torch.utils.config import RaisrConfig

    up_err = {k: 0.0 for k in ("upscale_planes", "upscale_planes_generic")}
    ap_err = {k: 0.0 for k in ("raisr_apply_generic", "raisr_apply_split")}
    hash_err = 0.0
    agree, differing = 1.0, 0

    def bucket_maps(hb, nbucket):
        """The hash's buckets; the first and the last bucket everywhere (one
        filter row for every pixel); uniformly random; random with holes of
        -1 and nbucket, which must give 0."""
        rand = torch.randint(0, nbucket, hb.shape, device=device, dtype=torch.int32)
        holes = torch.randint(0, nbucket, hb.shape, device=device, dtype=torch.int32)
        holes[..., ::7, ::5] = -1
        holes[..., 3::11, 1::3] = nbucket
        return {"hash": hb, "first": torch.zeros_like(hb), "last": torch.full_like(hb, nbucket - 1),
                "random": rand, "holes": holes}

    for name, model in models.items():
        cfg = model.cfg
        nbucket = cfg.num_angle * cfg.num_strength * cfg.num_coherence
        want = GENERIC_CONFIGS[name][1]
        shapes = [GENERIC_SHAPE] + ([(2, LR, LR)] if name == GENERIC_LARGE else [])
        inputs = [("lenna", torch.from_numpy(lenna_batch(rng, *shape)).to(device).float()
                   / torch.tensor(255.0, device=device), None) for shape in shapes]
        inputs += [("random", torch.from_numpy(rng.random(shape, dtype="float32")).to(device),
                    planes_geo) for shape, planes_geo in GENERIC_CASES]
        for tag, x01, planes_geo in inputs:
            geo = plane_geometry(x01.shape[1], x01.shape[2], cfg)
            h2p, w2p, hq, wq = planes_geo or (geo.h2p, geo.w2p, geo.hq, geo.wq)
            torch.cuda.synchronize()
            _build.reset_launches()
            up_k = ku.upscale_planes_kernel(x01, cfg, hq, wq, geo.hp)
            up_p = ku.upscale_planes(x01, cfg, hq, wq, geo.hp)
            err = (up_k - up_p).abs().max().item()
            up_name = ku.upscale_form(cfg.scale)
            up_err[up_name] = max(up_err[up_name], err)
            a, nd, hb = hash_agreement(f"{name}, {tag} LR {tuple(x01.shape)} planes "
                                       f"{tuple(up_k.shape)}", cfg, up_k, geo.hp, h2p, w2p)
            agree, differing = min(agree, a), differing + nd
            hb_p = kr.hash_planes(up_k, cfg, geo.hp, h2p, w2p)
            hash_err = max(hash_err, (hb - hb_p).abs().max().item())
            planes = torch.cat([up_k, 0.5 * up_k]).contiguous()
            errs = {}
            for kind, bk in bucket_maps(hb, nbucket).items():
                ap_k = kr.apply_filters_planes_kernel(planes, bk, model.filters, cfg)
                ap_p = kr.apply_filters_planes(planes, bk, model.filters, cfg)
                torch.cuda.synchronize()
                errs[kind] = (ap_k - ap_p).abs().max().item()
            out_of_range = ((bk < 0) | (bk >= nbucket)).repeat(2, 1, 1, 1)
            if ap_k[out_of_range].abs().max().item() != 0.0:
                raise AssertionError(f"{name}: an out-of-range bucket did not give 0")
            ap_name = kr.apply_form(cfg, w2p)
            ap_err[ap_name] = max(ap_err[ap_name], *errs.values())
            launched = {k: v for k, v in _build.LAUNCHES.items() if v}
            print(f"{name}, {tag} LR {tuple(x01.shape)}: upscale max|kernel - plain| {err:.3e}, "
                  f"{ap_name} max|kernel - plain| on the bucket maps " + ", ".join(
                      f"{k} {v:.3e}" for k, v in errs.items()) + f"; launches {launched}")
            forms = {ku.upscale_form(cfg.scale), kr.hash_form(cfg), ap_name}
            if not set(want) <= forms or set(launched) != forms:
                raise AssertionError(f"{name} ran {launched}, not the generic forms {want}")
            del up_k, up_p, hb, hb_p, planes, ap_k, ap_p
    # the generic apply forms sum the taps in the plain version's order: equal
    for change in GENERIC_HASH_BLURS:
        cfg = dataclasses.replace(RaisrConfig(), **change)
        x01 = torch.from_numpy(rng.random((2, 100, 75), dtype="float32")).to(device)
        geo = plane_geometry(100, 75, cfg)
        up = ku.upscale_planes_kernel(x01, cfg, geo.hq, geo.wq, geo.hp)
        a, nd, _ = hash_agreement(f"gauss_len {cfg.gauss_len}, random LR (2, 100, 75)", cfg, up,
                                  geo.hp, geo.h2p, geo.w2p)
        agree, differing = min(agree, a), differing + nd
    # the layouts the generic and the split apply carve out of shared memory
    # are written twice: in Python, which chooses the form and the plan on
    # any device, and in the .cu
    lib = _build.library()
    bucket_counts = (27, 72, 144, 216, 225, 288, 432, 1944)
    sizes = [(s, fl, nbk, p) for s in range(2, 7) for fl in range(1, 18)
             for nbk in bucket_counts for p in range(1, min(4, s * s) + 1)]
    off = [(k, kr.generic_apply_smem(*k), lib.ocvk_raisr_apply_generic_smem(*k))
           for k in sizes if kr.generic_apply_smem(*k) != lib.ocvk_raisr_apply_generic_smem(*k)]
    split_sizes = [(s, fl, nbk, q, p) for s in range(2, 7) for fl in range(1, 26, 2)
                   for nbk in bucket_counts for q in sorted({2, 4, 98, 146, 210, fl * fl + fl % 2})
                   for p in sorted({1, min(q, s * s)})]
    off += [(k, kr.split_apply_smem(*k), lib.ocvk_raisr_apply_split_smem(*k))
            for k in split_sizes if kr.split_apply_smem(*k) != lib.ocvk_raisr_apply_split_smem(*k)]
    print(f"apply shared memory: Python and the .cu agree on {len(sizes) + len(split_sizes) - len(off)} "
          f"of {len(sizes) + len(split_sizes)} layouts: {len(sizes)} generic (scale, filter_len, "
          f"buckets, phases), {len(split_sizes)} split (scale, filter_len, buckets, taps a split, "
          f"planes)")
    if off:
        raise AssertionError(f"the apply's shared memory differs from the .cu's: {off[:5]}")
    if (max(up_err.values()) > UPSCALE_TOL or max(ap_err.values()) != 0.0
            or agree < HASH_AGREEMENT):
        raise AssertionError(f"generic forms off their plain versions: upscale {up_err}, "
                             f"apply {ap_err}, hash agreement {agree}")
    print(f"generic forms: apply max|kernel - plain| {ap_err}, hash {differing} differing "
          f"buckets over every case (lowest agreement {agree:.7f})")
    return {"upscale_planes_generic": {"max_abs_err": up_err["upscale_planes_generic"]},
            "raisr_hash_generic": {"max_abs_err": hash_err, "agreement": agree,
                                   "differing": differing},
            **{k: {"max_abs_err": v} for k, v in ap_err.items()}}


def generic_main_path(models, rng, device):
    """Phase 4d: one ``RaisrModel.upsample`` per generic config on 2 lenna
    images of 256^2, the launch counts set to 0 just before it and read just
    after: it must launch the generic forms its config needs, and agree with
    the plain path on >= 99.9 % of the pixels within one level. Returns the
    generic forms' launches summed over the three runs."""
    import torch

    from oclcomputervision_tpu_torch.kernels import _build
    from oclcomputervision_tpu_torch.ops.raisr import PLAIN_STAGES, _raisr_planes_batched

    total = {k: 0 for k in GENERIC_KERNELS}
    for name, model in models.items():
        s = model.cfg.scale
        x = torch.from_numpy(lenna_batch(rng, 2, 256)).to(device)
        torch.cuda.synchronize()
        _build.reset_launches()
        out = model.upsample(x)
        torch.cuda.synchronize()
        launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        if tuple(out.shape) != (2, s * 256, s * 256) or out.dtype != torch.uint8:
            raise AssertionError(f"{name} output {tuple(out.shape)} {out.dtype}")
        plain = _raisr_planes_batched(x, model.filters, model.cfg, 1, PLAIN_STAGES)
        within = ((plain.int() - out.int()).abs() <= 1).float().mean().item()
        print(f"{name} RaisrModel.upsample {tuple(x.shape)} -> {tuple(out.shape)}: launches "
              f"{launches}; {within:.7f} of pixels within one level of the plain path "
              f"(min {E2E_WITHIN_ONE})")
        missing = [k for k in GENERIC_CONFIGS[name][1] if launches.get(k, 0) < 1]
        if missing or not within >= E2E_WITHIN_ONE:
            raise AssertionError(f"{name}: launched no {missing}, or {within} within one level")
        for k in GENERIC_KERNELS:
            total[k] += launches.get(k, 0)
    return total


def main_path(model, batch, rgb, rng, device):
    """Phase 4: the slice through the model, counting kernel launches; then
    ``blend='ct'`` and a BGRA image through the kernels."""
    import dataclasses

    import numpy as np
    import torch

    from oclcomputervision_tpu_torch.kernels import _build
    from oclcomputervision_tpu_torch.models.raisr import RaisrModel
    from oclcomputervision_tpu_torch.ops.raisr import PLAIN_STAGES, _raisr_planes_batched

    s = model.cfg.scale
    x = torch.from_numpy(batch).to(device)
    torch.cuda.synchronize()
    _build.reset_launches()
    out = model.upsample(x)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    n, h, w = batch.shape
    if tuple(out.shape) != (n, s * h, s * w) or out.dtype != torch.uint8:
        raise AssertionError(f"batch output {tuple(out.shape)} {out.dtype}")
    print(f"main path: {tuple(batch.shape)} uint8 -> {tuple(out.shape)} uint8, "
          f"launches {launches}")
    missing = [k for k in RAISR_KERNELS if launches[k] < 1]
    if missing:
        raise AssertionError(f"main path launched no {missing} kernel")
    if any(launches[k] for k in GENERIC_KERNELS):
        raise AssertionError(f"the shipped x2 bank launched a generic form: {launches}")

    rgb_t = torch.from_numpy(rgb).to(device)
    out_rgb = model.upsample(rgb_t)
    want = (s * rgb.shape[0], s * rgb.shape[1], 3)
    if tuple(out_rgb.shape) != want or out_rgb.dtype != torch.uint8:
        raise AssertionError(f"RGB output {tuple(out_rgb.shape)} {out_rgb.dtype}")
    plain = _raisr_planes_batched(rgb_t[None], model.filters, model.cfg, 3, PLAIN_STAGES)[0]
    within = ((plain.int() - out_rgb.int()).abs() <= 1).float().mean().item()
    print(f"RGB: {rgb.shape} uint8 -> {tuple(out_rgb.shape)} uint8, {within:.7f} of "
          f"values within one level of the plain path (min {E2E_WITHIN_ONE})")
    if not within >= E2E_WITHIN_ONE:
        raise AssertionError(f"RGB kernel and plain paths disagree: {within}")

    # census-transform blending on two gray images, and BGRA lenna (alpha
    # from the seed), each through the kernels and held against the plain path
    ct = RaisrModel(dataclasses.replace(model.cfg, blend="ct"), model.filters)
    alpha = rng.integers(0, 256, rgb.shape[:2], dtype=np.uint8)
    bgra = torch.from_numpy(np.concatenate([rgb[..., ::-1], alpha[..., None]], -1)).to(device)
    for tag, mdl, inp, nchan in (("blend='ct'", ct, x[:2], 1), ("BGRA", model, bgra[None], 4)):
        torch.cuda.synchronize()
        _build.reset_launches()
        got = mdl.upsample(inp)
        torch.cuda.synchronize()
        seen = {k: _build.LAUNCHES[k] for k in RAISR_KERNELS}
        plain = _raisr_planes_batched(inp, mdl.filters, mdl.cfg, nchan, PLAIN_STAGES)
        within = ((plain.int() - got.int()).abs() <= 1).float().mean().item()
        print(f"{tag}: {tuple(inp.shape)} uint8 -> {tuple(got.shape)} uint8, launches {seen}, "
              f"{within:.7f} of values within one level of the plain path (min {E2E_WITHIN_ONE})")
        if min(seen.values()) < 1 or not within >= E2E_WITHIN_ONE:
            raise AssertionError(f"{tag}: kernel and plain paths disagree ({within}) or a "
                                 f"kernel did not run ({seen})")
    if bool((got[..., 3] == 0).all()):
        raise AssertionError("BGRA alpha came out empty")
    return out, launches


def quality(model):
    """Phase 5: held-out frame11 and the numpy oracle."""
    import numpy as np

    from oclcomputervision_tpu_torch.ops.raisr import oracle_raisr
    from oclcomputervision_tpu_torch.utils import load_gray, psnr

    hr = load_gray("frame11.png")
    h, w = hr.shape[0] // 2 * 2, hr.shape[1] // 2 * 2
    hr = hr[:h, :w]
    lr = hr.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3)).round().astype(np.uint8)
    sr = model.upsample(lr).cpu().numpy()
    bil = oracle_raisr.cheap_upscale(lr.astype(np.float64) / 255.0, 2)
    bil = np.clip(np.rint(bil * 255.0), 0, 255).astype(np.uint8)
    p_sr, p_bil = psnr(sr, hr), psnr(bil, hr)
    ref = oracle_raisr.raisr_upsample(
        lr, model.filters.cpu().numpy().astype(np.float64), model.cfg
    )
    p_or = psnr(sr, ref)
    print(f"frame11 x2: RAISR {p_sr:.4f} dB, bilinear {p_bil:.4f} dB; "
          f"port vs numpy oracle {p_or:.4f} dB (min {ORACLE_PSNR})")
    if not p_sr > p_bil:
        raise AssertionError("RAISR does not beat bilinear on frame11")
    if not p_or > ORACLE_PSNR:
        raise AssertionError(f"port vs oracle {p_or} dB")
    return {"raisr_db": p_sr, "bilinear_db": p_bil, "vs_oracle_db": p_or}


def timing(model, batch, out_kernel, card, device):
    """Phase 6: end-to-end and per-kernel device times at the batch's shapes."""
    import torch

    from oclcomputervision_tpu_torch.kernels import raisr as kr
    from oclcomputervision_tpu_torch.kernels import upscale as ku
    from oclcomputervision_tpu_torch.ops.raisr import (
        PLAIN_STAGES,
        _raisr_planes_batched,
        plane_geometry,
    )
    from oclcomputervision_tpu_torch.utils import cuda_time_ms, device_profile

    cfg = model.cfg
    x = torch.from_numpy(batch).to(device)
    mp_out = x.numel() * cfg.scale**2 / 1e6
    shape = "x".join(str(d) for d in batch.shape)

    out_plain = _raisr_planes_batched(x, model.filters, cfg, 1, PLAIN_STAGES)
    diff = (out_plain.int() - out_kernel.int()).abs()
    within = (diff <= 1).float().mean().item()
    print(f"kernel path vs plain path, {tuple(batch.shape)}: {within:.7f} of pixels within one "
          f"level (min {E2E_WITHIN_ONE}), max diff {diff.max().item()}")
    if not within >= E2E_WITHIN_ONE:
        raise AssertionError(f"kernel and plain paths disagree: {within}")
    del out_plain, diff

    ms_k = cuda_time_ms(model.upsample, x)
    ms_p = cuda_time_ms(_raisr_planes_batched, x, model.filters, cfg, 1, PLAIN_STAGES)
    print(f"[{card}] e2e RAISR x2 {shape} uint8 kernels: {ms_k:.4f} ms, "
          f"{mp_out / ms_k * 1e3:.2f} MP out/s")
    print(f"[{card}] e2e RAISR x2 {shape} uint8 plain:   {ms_p:.4f} ms, "
          f"{mp_out / ms_p * 1e3:.2f} MP out/s")

    per_kernel, idle = device_profile(model.upsample, x)
    print(f"[{card}] torch.profiler, device ms per call of the {shape} batch "
          f"(idle share {idle:.4f}):")
    for name, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1]):
        print(f"    {ms:9.4f}  {name[:90]}")

    geo = plane_geometry(x.shape[1], x.shape[2], cfg)
    x01 = x.float() / torch.tensor(255.0, device=device)
    up = ku.upscale_planes_kernel(x01, cfg, geo.hq, geo.wq, geo.hp)
    hb = kr.hash_planes_kernel(up, cfg, geo.hp, geo.h2p, geo.w2p)
    pairs = {
        "upscale_planes": (
            lambda: ku.upscale_planes_kernel(x01, cfg, geo.hq, geo.wq, geo.hp),
            lambda: ku.upscale_planes(x01, cfg, geo.hq, geo.wq, geo.hp),
        ),
        "raisr_hash": (
            lambda: kr.hash_planes_kernel(up, cfg, geo.hp, geo.h2p, geo.w2p),
            lambda: kr.hash_planes(up, cfg, geo.hp, geo.h2p, geo.w2p),
        ),
        "raisr_apply": (
            lambda: kr.apply_filters_planes_kernel(up, hb, model.filters, cfg),
            lambda: kr.apply_filters_planes(up, hb, model.filters, cfg),
        ),
    }
    ap = kr.apply_filters_planes_kernel(up, hb, model.filters, cfg)
    moved = {
        "upscale_planes": (nbytes(x01, up), up.numel()),
        "raisr_hash": (nbytes(up, hb), hb.numel()),
        "raisr_apply": (nbytes(up, hb, model.filters, ap), ap.numel()),
    }
    # the one PyTorch call with the same values: align-corners bilinear to
    # the HR image, which the parity planes hold rearranged (plane a*s+b,
    # element (i, j) is HR pixel (s*(i - hp) + a, s*(j - hp) + b)); no single
    # call computes bucket maps or the bucket-selected filter
    s, (n, h, w) = cfg.scale, x01.shape
    library = {"upscale_planes": lambda: torch.nn.functional.interpolate(
        x01[:, None], size=(s * h, s * w), mode="bilinear", align_corners=True)}
    hr = library["upscale_planes"]()[:, 0]
    inner = up[:, :, geo.hp : geo.hp + h, geo.hp : geo.hp + w]
    lib_err = (inner.reshape(n, s, s, h, w).permute(0, 3, 1, 4, 2).reshape(n, s * h, s * w)
               - hr).abs().max().item()
    print(f"upscale_planes vs F.interpolate(align_corners=True) inside the image: "
          f"max |diff| {lib_err:.3e} (tol {LIBRARY_UPSCALE_TOL:.0e})")
    if not lib_err <= LIBRARY_UPSCALE_TOL:
        raise AssertionError(f"F.interpolate is not the upscale's function: {lib_err}")
    del hr, inner
    times = {}
    for name, (fk, fp) in pairs.items():
        ms, call_ms, pms = kernel_ms(name, fk), cuda_time_ms(fk), cuda_time_ms(fp)
        lms = cuda_time_ms(library[name]) if name in library else None
        bms, by = bound(name, *moved[name])
        times[name] = {"ms": ms, "call_ms": call_ms, "plain_ms": pms, "bound_ms": bms,
                       "bound_by": by, "library_ms": lms}
        lib = "none" if lms is None else f"{lms:.4f} ms (F.interpolate, HR image)"
        print(f"[{card}] {name} at {shape}: kernel {ms:.4f} ms (whole call {call_ms:.4f} ms), "
              f"plain {pms:.4f} ms, bound {bms:.4f} ms ({by}: {moved[name][0] / 1e6:.1f} MB), "
              f"library {lib}")
    up_t = times["upscale_planes"]
    print(f"[{card}] upscale_planes kernel / F.interpolate: "
          f"{up_t['ms'] / up_t['library_ms']:.4f}")
    # the filter rows a warp gathers from shared memory collide more the less
    # its buckets cluster: natural images are the favourable case
    gen = torch.Generator(device=device).manual_seed(0)
    rand = torch.randint(0, cfg.num_angle * cfg.num_strength * cfg.num_coherence, hb.shape,
                         generator=gen, device=device, dtype=torch.int32)
    rand_ms = kernel_ms("raisr_apply", lambda: kr.apply_filters_planes_kernel(
        up, rand, model.filters, cfg))
    times["raisr_apply"]["random_buckets_ms"] = rand_ms
    # the hash on uniformly random luma beside the bench images
    x_rand = torch.rand(x01.shape, generator=gen, device=device)
    up_rand = ku.upscale_planes_kernel(x_rand, cfg, geo.hq, geo.wq, geo.hp)
    hash_rand_ms = kernel_ms("raisr_hash", lambda: kr.hash_planes_kernel(
        up_rand, cfg, geo.hp, geo.h2p, geo.w2p))
    times["raisr_hash"]["random_luma_ms"] = hash_rand_ms
    print(f"[{card}] raisr_hash at {shape}: {times['raisr_hash']['ms']:.4f} ms on the bench "
          f"images, {hash_rand_ms:.4f} ms on uniformly random luma")
    del x_rand, up_rand
    passes = bank_passes(hb[:2]), bank_passes(rand[:2])
    print(f"[{card}] raisr_apply at {shape}: {times['raisr_apply']['ms']:.4f} ms on the "
          f"hash's own buckets ({passes[0]:.4f} shared-memory passes per filter-row load), "
          f"{rand_ms:.4f} ms on uniformly random buckets ({passes[1]:.4f} passes)")
    return times, {"e2e_ms": ms_k, "e2e_plain_ms": ms_p, "idle_share": idle,
                   "mp_out_per_s": mp_out / ms_k * 1e3,
                   "plain_mp_out_per_s": mp_out / ms_p * 1e3}


def generic_timing(models, rng, card, device):
    """Phase 6d: each generic RAISR form's own device time at GENERIC_SHAPE
    (lenna) at the config GENERIC_TIMED names, beside its bound, its plain
    version's time and, for the upscale, F.interpolate's (checked to give the
    same values); then the x5 hash and apply, and the compiled forms' times
    at the same shape for comparison."""
    import torch

    from oclcomputervision_tpu_torch.kernels import raisr as kr
    from oclcomputervision_tpu_torch.kernels import upscale as ku
    from oclcomputervision_tpu_torch.ops.raisr import plane_geometry
    from oclcomputervision_tpu_torch.utils import cuda_time_ms

    x = torch.from_numpy(lenna_batch(rng, *GENERIC_SHAPE)).to(device)
    x01 = x.float() / torch.tensor(255.0, device=device)
    n, h, w = x01.shape
    shape = "x".join(str(d) for d in x01.shape)

    def stages(cfg, filters):
        geo = plane_geometry(h, w, cfg)
        up = ku.upscale_planes_kernel(x01, cfg, geo.hq, geo.wq, geo.hp)
        hb = kr.hash_planes_kernel(up, cfg, geo.hp, geo.h2p, geo.w2p)
        ap = kr.apply_filters_planes_kernel(up, hb, filters, cfg)
        return {
            ku.upscale_form(cfg.scale): (
                lambda: ku.upscale_planes_kernel(x01, cfg, geo.hq, geo.wq, geo.hp),
                lambda: ku.upscale_planes(x01, cfg, geo.hq, geo.wq, geo.hp),
                nbytes(x01, up), up.numel(), None),
            kr.hash_form(cfg): (
                lambda: kr.hash_planes_kernel(up, cfg, geo.hp, geo.h2p, geo.w2p),
                lambda: kr.hash_planes(up, cfg, geo.hp, geo.h2p, geo.w2p),
                nbytes(up, hb), hb.numel(), hash_ops(cfg)),
            kr.apply_form(cfg, geo.w2p): (
                lambda: kr.apply_filters_planes_kernel(up, hb, filters, cfg),
                lambda: kr.apply_filters_planes(up, hb, filters, cfg),
                nbytes(up, hb, filters, ap), ap.numel(), 2 * cfg.filter_len**2),
        }, geo, up

    times = {}
    for name, config in GENERIC_TIMED.items():
        model = models[config]
        runs, geo, up = stages(model.cfg, model.filters)
        fk, fp, moved, elems, ops = runs[name]
        ms, pms = kernel_ms(name, fk), cuda_time_ms(fp)
        bms, by = bound(name, moved, elems, ops)
        lms = None
        if name == "upscale_planes_generic":
            s = model.cfg.scale
            lib = lambda: torch.nn.functional.interpolate(  # noqa: E731
                x01[:, None], size=(s * h, s * w), mode="bilinear", align_corners=True)
            inner = up[:, :, geo.hp : geo.hp + h, geo.hp : geo.hp + w]
            err = (inner.reshape(n, s, s, h, w).permute(0, 3, 1, 4, 2).reshape(n, s * h, s * w)
                   - lib()[:, 0]).abs().max().item()
            if not err <= LIBRARY_UPSCALE_TOL:
                raise AssertionError(f"F.interpolate is not the x{s} upscale's function: {err}")
            lms = cuda_time_ms(lib)
        times[name] = {"ms": ms, "plain_ms": pms, "bound_ms": bms, "bound_by": by,
                       "library_ms": lms, "config": config}
        lib_txt = "none" if lms is None else f"{lms:.4f} ms (F.interpolate, HR image)"
        print(f"[{card}] {name} at {shape}, {config}: kernel {ms:.4f} ms, plain {pms:.4f} ms, "
              f"bound {bms:.4f} ms ({by}: {moved / 1e6:.1f} MB), library {lib_txt}")
    # every stage of every generic config, generic or compiled, at this shape
    for config, model in models.items():
        runs, _, _ = stages(model.cfg, model.filters)
        print(f"[{card}] {config} at {shape}: " + ", ".join(
            f"{name} {kernel_ms(name, run[0]):.4f} ms" for name, run in runs.items()))
    return times


def generic_bench(models, rng, x2_mp_out_per_s, card, device):
    """Phase 6e: each GENERIC_BENCH config's ``RaisrModel.upsample`` at the bench
    geometry (BATCH x LR^2 uint8 lenna, through the kernels only: the plain
    path at that size takes too long and, at x5, too much memory): output
    MP/s from CUDA events (median of 5 after 2 warm-ups) beside the shipped
    x2 model's, each stage's own device time (torch.profiler) and its bound
    (the bytes it must move, or hash_ops(cfg) and 2 fl^2 operations per HR
    pixel). The generic forms must have run. Then the hash (on 2 images)
    and the apply (on all) at this geometry against their plain versions."""
    import torch

    from oclcomputervision_tpu_torch.kernels import raisr as kr
    from oclcomputervision_tpu_torch.kernels import upscale as ku
    from oclcomputervision_tpu_torch.ops.raisr import plane_geometry
    from oclcomputervision_tpu_torch.utils import cuda_time_ms, device_profile

    x = torch.from_numpy(lenna_batch(rng, BATCH, LR)).to(device)
    n, h, w = x.shape
    shape = "x".join(str(d) for d in x.shape)
    x01 = x[:2].float() / torch.tensor(255.0, device=device)
    results = {}
    for config in GENERIC_BENCH:
        model = models[config]
        cfg = model.cfg
        s, fl = cfg.scale, cfg.filter_len
        geo = plane_geometry(h, w, cfg)
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_time_ms(model.upsample, x)
        peak = torch.cuda.max_memory_allocated() / 2**30
        mp_out = n * h * w * s * s / 1e6
        per_kernel, idle = device_profile(model.upsample, x)
        # bytes each stage must move: LR f32 in and planes out; planes in and
        # buckets out; planes, buckets and bank in, filtered planes out
        planes = n * s * s * geo.hq * geo.wq * 4
        plane_px = n * s * s * geo.h2p * geo.w2p
        stage_io = {
            ku.upscale_form(s): (n * h * w * 4 + planes, n * s * s * geo.hq * geo.wq, None),
            kr.hash_form(cfg): (planes + plane_px * 4, plane_px, hash_ops(cfg)),
            kr.apply_form(cfg, geo.w2p): (planes + plane_px * 8 + model.filters.numel() * 4,
                                          plane_px, 2 * fl * fl),
        }
        stages = {}
        for name, (moved, elems, ops) in stage_io.items():
            hits = [v for k, v in per_kernel.items() if f"{name}_kernel" in k]
            if not hits:
                raise AssertionError(f"{config}: the profiler saw no {name} kernel")
            bms, by = bound(name, moved, elems, ops)
            stages[name] = {"ms": sum(hits), "bound_ms": bms, "bound_by": by}
        glue = sum(per_kernel.values()) - sum(v["ms"] for v in stages.values())
        # the hash against its plain version on two images, whose grid still
        # gives every SM 4 blocks of full-height strips (128 HR rows at x2,
        # 125 at x5) as the batch's does; the filter-row loads'
        # shared-memory passes on their buckets (the generic form's warps
        # read rows as raisr_apply.cu's do)
        up = ku.upscale_planes_kernel(x01, cfg, geo.hq, geo.wq, geo.hp)
        agree, ndiff, hb = hash_agreement(f"lenna {tuple(x01.shape)} (6e, config '{config}')",
                                          cfg, up, geo.hp, geo.h2p, geo.w2p)
        passes = bank_passes(hb)
        del up, hb
        # the apply on the whole batch (every tile the timed runs walk)
        # against its plain version: equal
        xb = x.float() / torch.tensor(255.0, device=device)
        up = ku.upscale_planes_kernel(xb, cfg, geo.hq, geo.wq, geo.hp)
        del xb
        hb = kr.hash_planes_kernel(up, cfg, geo.hp, geo.h2p, geo.w2p)
        got = kr.apply_filters_planes_kernel(up, hb, model.filters, cfg)
        ap_err = (got - kr.apply_filters_planes(up, hb, model.filters, cfg)).abs().max().item()
        del up, hb, got
        print(f"{config}, lenna {shape} (6e): {kr.apply_form(cfg, geo.w2p)} max|kernel - plain| "
              f"{ap_err:.3e}")
        if ap_err != 0.0:
            raise AssertionError(f"{config}: the apply is off its plain version by {ap_err} "
                                 f"at {shape}")
        results[config] = {"e2e_ms": ms, "mp_out_per_s": mp_out / ms * 1e3, "idle_share": idle,
                           "peak_gib": peak, "stages": stages, "glue_ms": glue,
                           "bank_passes": passes, "hash_agreement": agree,
                           "hash_differing": ndiff, "apply_max_abs_err": ap_err}
        print(f"[{card}] 6e {config}, {shape} uint8 -> {n}x{s * h}x{s * w}: {ms:.4f} ms, "
              f"{mp_out / ms * 1e3:.2f} MP out/s (shipped x2: {x2_mp_out_per_s:.2f}), idle share "
              f"{idle:.4f}, peak {peak:.2f} GiB; " + ", ".join(
                  f"{k} {v['ms']:.4f} ms (bound {v['bound_ms']:.4f}, {v['bound_by']})"
                  for k, v in stages.items()) + f", glue {glue:.4f} ms; {passes:.4f} "
              f"shared-memory passes per filter-row load")
        torch.cuda.empty_cache()
    return results


def histeq_batches(rng, device):
    """The histeq inputs at bench.py's global geometry: random uint8 (the
    bench's content, from the seed), natural (lenna tiled, rolled, +-8
    noise) and constant (every pixel 77: one bin, the worst case for
    atomics)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(int(rng.integers(1 << 31)))
    return {
        "random": torch.randint(0, 256, GLOBAL_SHAPE, generator=gen, device=device,
                                dtype=torch.uint8),
        "natural": torch.from_numpy(lenna_batch(rng, *GLOBAL_SHAPE)).to(device),
        "constant": torch.full(GLOBAL_SHAPE, 77, dtype=torch.uint8, device=device),
    }


def histeq_kernel_vs_plain(batches, rng, device):
    """Phase 3b: each histeq kernel and its plain version on the same
    inputs; they must be equal (counts and bytes; the blend rounds every
    product and sum in the plain version's order)."""
    import torch

    from oclcomputervision_tpu_torch.kernels import histeq as kh
    from oclcomputervision_tpu_torch.kernels import localeq as kl
    from oclcomputervision_tpu_torch.ops.histeq import calc_transfer_func

    errs = {k: 0.0 for k in GLOBAL_KERNELS + LOCAL_KERNELS}

    def check(name, tag, got, want):
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{name} {tag}: {tuple(got.shape)} {got.dtype} vs "
                                 f"{tuple(want.shape)} {want.dtype}")
        err = (got.double() - want.double()).abs().max().item()
        errs[name] = max(errs[name], err)
        print(f"{name} {tag} {tuple(got.shape)}: max|kernel - plain| = {err}")

    def run(tag, g_global, g_local, tile, blockshape, m4=None):
        flat = g_global.reshape(g_global.shape[0], -1)
        hist = kh.hist256(flat)
        check("hist256", tag, kh.hist256_kernel(flat), hist)
        luts = calc_transfer_func(hist, 1.0, 0.05, 2.0).to(torch.uint8)
        check("apply_lut", tag, kh.apply_lut_kernel(flat, luts), kh.apply_lut(flat, luts))
        tiles = kl.hist_tiles(g_local, tile)
        check("hist_tiles", tag, kl.hist_tiles_kernel(g_local, tile), tiles)
        if m4 is None:  # the op's own LUTs
            m4 = calc_transfer_func(tiles, 0.5, 0.05, 3.0)
        check("blend_blocks", tag, kl.blend_blocks_kernel(g_local, m4, blockshape),
              kl.blend_blocks(g_local, m4, blockshape))

    for name, x in batches.items():
        run(name, x, x[: LOCAL_SHAPE[0]], BLOCK, BLOCK)
    gen = torch.Generator(device=device).manual_seed(int(rng.integers(1 << 31)))
    odd = torch.randint(0, 256, (3, 101, 77), generator=gen, device=device, dtype=torch.uint8)
    # LUT values outside [0, 255] exercise the clip; (50, 38) blocks leave a
    # ragged edge the 2x2 grid must cover
    m_odd = torch.rand((3, 2, 2, 256), generator=gen, device=device) * 300.0 - 20.0
    run("odd", odd, odd, (101, 7), (50, 38), m_odd)
    # a row one byte past a 16-byte boundary: scalar head, vector body, tail
    row = batches["natural"].reshape(-1)[1 : 1 + 1_000_003].reshape(1, -1)
    check("hist256", "offset", kh.hist256_kernel(row), kh.hist256(row))
    lut = torch.randint(0, 256, (1, 256), generator=gen, device=device, dtype=torch.uint8)
    check("apply_lut", "offset", kh.apply_lut_kernel(row, lut), kh.apply_lut(row, lut))
    # a rank's rows of phase 8's 8K frame, as histeq_global_sharded hands
    # them over: one histogram per row, then one LUT over all of them
    h, w = SHARD_GLOBAL
    shard = batches["natural"].reshape(-1)[: h // SHARD_RANKS * w].reshape(-1, w)
    check("hist256", "8K rank rows", kh.hist256_kernel(shard), kh.hist256(shard))
    flat = shard.reshape(1, -1)
    check("apply_lut", "8K rank rows", kh.apply_lut_kernel(flat, lut), kh.apply_lut(flat, lut))
    # the blend of phase 8's bands of a 4096 x 8192 image (each rank's rows
    # from y0 = rank x rows, the whole image's LUT grid), of a band from
    # -bh/2 (apply_block_mappings_band's first: rows above the image are
    # zero), one from an unaligned row and one that reaches past the bottom
    # into the padding; with the image's own LUTs and random ones outside
    # [0, 255]. Each must also equal the whole image's blend on its rows.
    h, w = SHARD_LOCAL
    bh = BLOCK[0]
    img = torch.from_numpy(lenna_batch(rng, 1, h, w)).to(device)
    tiles = kl.hist_tiles(img, BLOCK)
    h_loc = h // SHARD_RANKS
    for r in range(SHARD_RANKS):  # histeq_local_sharded's tile histograms of a rank's rows
        part = img[:, r * h_loc : (r + 1) * h_loc].contiguous()
        check("hist_tiles", f"4096 x 8192 rank {r} rows", kl.hist_tiles_kernel(part, BLOCK),
              tiles[:, r * h_loc // BLOCK[0] : (r + 1) * h_loc // BLOCK[0]])
    bands = [(r * h_loc, h_loc) for r in range(SHARD_RANKS)]
    bands += [(-(bh // 2), 3 * bh), (77, 300), (h - 333, 333 + bh // 2)]
    luts = {"own": calc_transfer_func(tiles, 0.5, 0.05, 3.0),
            "random": torch.rand(tiles.shape, generator=gen, device=device) * 300.0 - 20.0}
    for kind, m4 in luts.items():
        whole = kl.blend_blocks_kernel(img, m4, BLOCK)
        check("blend_blocks", f"4096 x 8192, {kind} LUTs", whole, kl.blend_blocks(img, m4, BLOCK))
        for y0, rows in bands:
            band = torch.zeros((1, rows, w), dtype=torch.uint8, device=device)
            lo, hi = max(0, y0), min(h, y0 + rows)
            band[0, lo - y0 : hi - y0] = img[0, lo:hi]
            got = kl.blend_blocks_kernel(band, m4, BLOCK, y0)
            check("blend_blocks", f"band y0 {y0}, {kind} LUTs", got,
                  kl.blend_blocks(band, m4, BLOCK, y0))
            if not torch.equal(got[0, lo - y0 : hi - y0], whole[0, lo:hi]):
                raise AssertionError(f"blend_blocks band y0 {y0}, {kind} LUTs: not the whole "
                                     f"image's rows {lo}:{hi}")
    bad = {k: v for k, v in errs.items() if v != 0.0}
    if bad:
        raise AssertionError(f"histeq kernels differ from their plain versions: {bad}")
    return {k: {"max_abs_err": v} for k, v in errs.items()}


def histeq_main_path(batches, rng, device):
    """Phase 4b: the histeq ops end to end, each path with the launch counts
    set to 0 just before it and read just after; outputs against the plain
    path and one natural image against the numpy oracle."""
    import numpy as np
    import torch

    from oclcomputervision_tpu_torch import ops
    from oclcomputervision_tpu_torch.kernels import _build
    from oclcomputervision_tpu_torch.oracle import histeq as oracle
    from oclcomputervision_tpu_torch.ops.histeq import (
        PLAIN_STAGES,
        _histeq_global_batched,
        _histeq_local_batched,
    )

    def drive(tag, kernels, fn, *args):
        torch.cuda.synchronize()
        _build.reset_launches()
        out = fn(*args)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        print(f"{tag}: {tuple(args[0].shape)} uint8 -> {tuple(out.shape)} {out.dtype}, "
              f"launches {launches}")
        missing = [k for k in kernels if launches[k] < 1]
        if missing:
            raise AssertionError(f"{tag} launched no {missing} kernel")
        if out.shape != args[0].shape or out.dtype != torch.uint8:
            raise AssertionError(f"{tag} output {tuple(out.shape)} {out.dtype}")
        return out, launches

    def same(tag, got, want):
        if not torch.equal(got, want):
            n = (got != want).sum().item()
            raise AssertionError(f"{tag}: {n} pixels differ from the plain path")
        print(f"{tag}: equal to the plain path")

    x = batches["natural"]
    img0 = x[0].cpu().numpy()
    out, launches_g = drive("histeq_global", GLOBAL_KERNELS, ops.histeq_global, x)
    same("histeq_global", out, _histeq_global_batched(x, 1.0, 0.05, 2.0, PLAIN_STAGES))
    d = np.abs(out[0].cpu().numpy().astype(int) - oracle.histeq_global(img0).astype(int))
    print(f"histeq_global vs numpy oracle, natural {img0.shape}: max {d.max()}, "
          f"share off {(d > 0).mean():.7f} (<= 1 on < {HISTEQ_ORACLE_SHARE})")
    if d.max() > 1 or (d > 0).mean() >= HISTEQ_ORACLE_SHARE:
        raise AssertionError("histeq_global disagrees with the oracle")
    del out

    xl = x[: LOCAL_SHAPE[0]]
    launches_l = None
    for clahe in (0.0, 2.0):
        tag = f"histeq_local_block clahe_clip={clahe}"
        out, launches = drive(tag, LOCAL_KERNELS, ops.histeq_local_block,
                              xl, 0.5, 0.05, 3.0, BLOCK, clahe)
        launches_l = launches_l or launches
        same(tag, out, _histeq_local_batched(xl, 0.5, 0.05, 3.0, BLOCK, clahe, PLAIN_STAGES))
        want = oracle.histeq_local_block(img0.copy(), 0.5, 0.05, 3.0, BLOCK, clahe_clip=clahe)
        d = np.abs(out[0].cpu().numpy().astype(int) - want.astype(int))
        print(f"{tag} vs numpy oracle, natural {img0.shape}: max {d.max()} (<= 1)")
        if d.max() > 1:
            raise AssertionError(f"{tag} disagrees with the oracle")

    # caller-given mappings on a geometry the blocks do not divide
    m = ops.block_mappings(x[:2], 0.5, 0.05, 3.0, BLOCK)
    big = torch.from_numpy(lenna_batch(rng, *MAPPED_SHAPE)).to(device)
    out, _ = drive("apply_block_mappings", ("blend_blocks",), ops.apply_block_mappings,
                   big, m, BLOCK)
    same("apply_block_mappings", out, PLAIN_STAGES.blend(big, m, BLOCK))
    want = oracle.apply_block_mappings(big[0].cpu().numpy(), m[0].cpu().numpy(), BLOCK)
    d = np.abs(out[0].cpu().numpy().astype(int) - want.astype(int))
    print(f"apply_block_mappings {tuple(big.shape)}, {tuple(m.shape[1:3])} LUT grid vs "
          f"numpy oracle: max {d.max()} (<= 1)")
    if d.max() > 1:
        raise AssertionError("apply_block_mappings disagrees with the oracle")
    return {**{k: launches_g[k] for k in GLOBAL_KERNELS},
            **{k: launches_l[k] for k in LOCAL_KERNELS}}


def histeq_timing(batches, card, device):
    """Phase 6b: both ops' input MP/s through the kernels and the plain
    versions, their device profiles, and each kernel's, plain version's and
    single PyTorch call's time at the bench shapes."""
    import torch

    from oclcomputervision_tpu_torch import ops
    from oclcomputervision_tpu_torch.kernels import histeq as kh
    from oclcomputervision_tpu_torch.kernels import localeq as kl
    from oclcomputervision_tpu_torch.ops.histeq import (
        PLAIN_STAGES,
        _histeq_global_batched,
        _histeq_local_batched,
        calc_transfer_func,
    )
    from oclcomputervision_tpu_torch.utils import cuda_time_ms, device_profile

    x = batches["random"]  # bench.py's content
    xl = x[: LOCAL_SHAPE[0]]
    runs = {
        "histeq_global": (x, (ops.histeq_global, x),
                          (_histeq_global_batched, x, 1.0, 0.05, 2.0, PLAIN_STAGES)),
        "histeq_local_block": (xl, (ops.histeq_local_block, xl, 0.5, 0.05, 3.0, BLOCK),
                               (_histeq_local_batched, xl, 0.5, 0.05, 3.0, BLOCK, 0.0,
                                PLAIN_STAGES)),
    }
    e2e = {}
    for op, (inp, kern, plain) in runs.items():
        shape = "x".join(str(d) for d in inp.shape)
        mp = inp.numel() / 1e6
        ms_k, ms_p = cuda_time_ms(*kern), cuda_time_ms(*plain)
        print(f"[{card}] e2e {op} {shape} uint8 kernels: {ms_k:.4f} ms, "
              f"{mp / ms_k * 1e3:.2f} MP in/s")
        print(f"[{card}] e2e {op} {shape} uint8 plain:   {ms_p:.4f} ms, "
              f"{mp / ms_p * 1e3:.2f} MP in/s")
        per_kernel, idle = device_profile(*kern)
        print(f"[{card}] torch.profiler, device ms per call of {op} {shape} "
              f"(idle share {idle:.4f}):")
        for name, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1]):
            print(f"    {ms:9.4f}  {name[:90]}")
        e2e[op] = {"ms": ms_k, "plain_ms": ms_p, "idle_share": idle,
                   "mp_in_per_s": mp / ms_k * 1e3, "plain_mp_in_per_s": mp / ms_p * 1e3,
                   "device_ms": sum(per_kernel.values())}

    flat = x.reshape(x.shape[0], -1)
    hist = kh.hist256_kernel(flat)
    luts = calc_transfer_func(hist, 1.0, 0.05, 2.0).to(torch.uint8)
    tiles = kl.hist_tiles_kernel(xl, BLOCK)
    m4 = calc_transfer_func(tiles, 0.5, 0.05, 3.0)
    # the single PyTorch calls take int64 indices; building them is timed
    # apart (printed) and left out of library_ms
    rows = torch.arange(flat.shape[0], device=device)[:, None]
    bin_idx = (flat.long() + 256 * rows).reshape(-1)
    lut_idx = flat.long()
    nrow = flat.shape[0]
    # tile histograms: bin x + 256 * (flat tile index of the pixel)
    (nb, hl, wl), (th, tw) = xl.shape, BLOCK
    nty, ntx = hl // th, wl // tw
    ntile = nb * nty * ntx
    tile_off = 256 * ((torch.arange(nb, device=device)[:, None, None] * nty
                       + torch.arange(hl, device=device)[:, None] // th) * ntx
                      + torch.arange(wl, device=device) // tw)
    tile_idx = (xl.long() + tile_off).reshape(-1)
    library_out = {
        "hist256": (torch.bincount(bin_idx, minlength=256 * nrow).reshape(nrow, 256), hist),
        "apply_lut": (torch.gather(luts, 1, lut_idx), kh.apply_lut_kernel(flat, luts)),
        "hist_tiles": (torch.bincount(tile_idx, minlength=256 * ntile)
                       .reshape(nb, nty, ntx, 256), tiles),
    }
    for name, (lib, ours) in library_out.items():
        if not torch.equal(lib.to(ours.dtype), ours):
            raise AssertionError(f"the library call of {name} computes another function")
    print(f"library calls equal the kernels: {sorted(library_out)}")
    del library_out
    pairs = {
        "hist256": (lambda: kh.hist256_kernel(flat), lambda: kh.hist256(flat),
                    lambda: torch.bincount(bin_idx, minlength=256 * nrow),
                    lambda: torch.bincount((flat.long() + 256 * rows).reshape(-1),
                                           minlength=256 * nrow),
                    nbytes(flat, hist), flat.numel(), "torch.bincount(x + 256 b)"),
        "apply_lut": (lambda: kh.apply_lut_kernel(flat, luts), lambda: kh.apply_lut(flat, luts),
                      lambda: torch.gather(luts, 1, lut_idx),
                      lambda: torch.gather(luts, 1, flat.long()),
                      nbytes(flat, luts, flat), flat.numel(), "torch.gather(lut, 1, x)"),
        "hist_tiles": (lambda: kl.hist_tiles_kernel(xl, BLOCK), lambda: kl.hist_tiles(xl, BLOCK),
                       lambda: torch.bincount(tile_idx, minlength=256 * ntile),
                       lambda: torch.bincount((xl.long() + tile_off).reshape(-1),
                                              minlength=256 * ntile),
                       nbytes(xl, tiles), xl.numel(), "torch.bincount(x + 256 tile)"),
        "blend_blocks": (lambda: kl.blend_blocks_kernel(xl, m4, BLOCK),
                         lambda: kl.blend_blocks(xl, m4, BLOCK), None, None,
                         nbytes(xl, m4, xl), xl.numel(), "none"),
    }
    times = {}
    for name, (fk, fp, flib, flib_conv, moved, elems, lib_name) in pairs.items():
        shape = "x".join(str(d) for d in (x if name in GLOBAL_KERNELS else xl).shape)
        ms, call_ms, pms = kernel_ms(name, fk), cuda_time_ms(fk), cuda_time_ms(fp)
        cold = kernel_ms(name, fk, cold_l2=True)
        lms = cuda_time_ms(flib) if flib else None
        bms, by = bound(name, moved, elems)
        times[name] = {"ms": ms, "call_ms": call_ms, "plain_ms": pms, "bound_ms": bms,
                       "bound_by": by, "library_ms": lms, "warm_l2_ms": ms, "cold_l2_ms": cold}
        print(f"[{card}] {name} at {shape}: kernel {ms:.4f} ms with L2 as the last call left "
              f"it, {cold:.4f} ms with L2 flushed before each call")
        if name == "apply_lut":
            # the 503 MB it moves pass through a 50 MB L2 that the timing loop
            # leaves holding the last call's lines: its row is the cold time
            times[name]["ms"] = ms = cold
        lib = "none" if lms is None else (
            f"{lms:.4f} ms ({lib_name}; {cuda_time_ms(flib_conv):.4f} ms with the int64 "
            f"index build)")
        print(f"[{card}] {name} at {shape}: kernel {ms:.4f} ms (whole call {call_ms:.4f} ms), "
              f"plain {pms:.4f} ms, bound {bms:.4f} ms ({by}: {moved / 1e6:.1f} MB), "
              f"library {lib}")
    del bin_idx, lut_idx, tile_idx, tile_off
    # the histogram kernels' time on other content (atomics depend on it)
    for content in ("natural", "constant"):
        xc = batches[content]
        fc = xc.reshape(xc.shape[0], -1)
        xcl = xc[: LOCAL_SHAPE[0]]
        print(f"[{card}] hist256 at {GLOBAL_SHAPE} {content}: "
              f"{kernel_ms('hist256', lambda: kh.hist256_kernel(fc)):.4f} ms; hist_tiles at "
              f"{LOCAL_SHAPE} {content}: "
              f"{kernel_ms('hist_tiles', lambda: kl.hist_tiles_kernel(xcl, BLOCK)):.4f} ms")
    return times, e2e


def noisy_pairs(rng, n: int):
    """bench.py's motion input: the Middlebury pair, per pair additive noise
    in [-4, 4] on both frames. Two uint8 [n, 480, 640] arrays."""
    import numpy as np

    from oclcomputervision_tpu_torch.utils import load_gray

    def noisy(g):
        return np.clip(g.astype(np.int16)[None] + rng.integers(-4, 5, (n, *g.shape)),
                       0, 255).astype(np.uint8)

    return noisy(load_gray("frame10.png")), noisy(load_gray("frame11.png"))


def me_kernel_vs_plain(rng, device):
    """Phase 3c: each motion kernel and its plain version on the same inputs;
    the searches are integer, so they must be equal."""
    import warnings

    import numpy as np
    import torch

    from oclcomputervision_tpu_torch.kernels import motion as km
    from oclcomputervision_tpu_torch.ops import motion as om

    errs = {k: 0.0 for k in ME_KERNELS}

    def check(names, tag, got, want):
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{names} {tag}: {tuple(got.shape)} {got.dtype} vs "
                                 f"{tuple(want.shape)} {want.dtype}")
        err = (got.double() - want.double()).abs().max().item()
        for name in names:
            errs[name] = max(errs[name], err)
        print(f"{'+'.join(names)} {tag} {tuple(got.shape)}: max|kernel - plain| = {err}")

    def seed_of(shape, amp):
        return torch.from_numpy(
            rng.uniform(-amp, amp, (*shape, 2)).astype("float32")).to(device)

    n0, n1 = noisy_pairs(rng, 2)
    gen = torch.Generator(device=device).manual_seed(int(rng.integers(1 << 31)))
    odd = torch.randint(0, 256, (2, 3, 101, 77), generator=gen, device=device,
                        dtype=torch.uint8)
    # 77 columns, not a multiple of 4, and odd[1] ends on the last byte of
    # its allocation
    inputs = {"vga": (torch.from_numpy(n0).to(device), torch.from_numpy(n1).to(device)),
              "odd": (odd[0], odd[1])}
    fast = ("me_fast_round", "me_fast_median")
    for tag, (f0, f1) in inputs.items():
        # 9/3 takes the kernel's path for any patch size, 11/5 two rounds
        for search, patch in (ME_GEOMETRY,) if tag == "vga" else (ME_GEOMETRY, (9, 3), (11, 5)):
            geo = f"{tag} {search}/{patch}"
            for costfn in ("sad", "ssd"):
                check(("me_exact",), f"{geo} {costfn} unseeded",
                      km.me_exact_kernel(f0, f1, search, patch, costfn),
                      km.me_exact(f0, f1, search, patch, costfn))
                check(fast, f"{geo} {costfn} unseeded",
                      km.me_fast_kernel(f0, f1, search, patch, costfn),
                      km.me_fast(f0, f1, search, patch, costfn))
            for amp, bound in ((6, 8), (29, 32), (40, None)):
                sd = seed_of(f0.shape, amp)
                for mode in ("shipped", "fixed"):
                    check(("me_exact",), f"{geo} seed +-{amp} bound {bound} {mode}",
                          km.me_exact_kernel(f0, f1, search, patch, "sad", sd, bound, mode),
                          km.me_exact(f0, f1, search, patch, "sad", sd, bound, mode))
                # fast mode around the seed: residual form, clamped base, per-round gather
                for wb in (-1, 16, None):
                    got, want = (om._fast(f0, f1, sd, search, patch, "fixed", wb, "sad", st)
                                 for st in (om.KERNEL_STAGES, om.PLAIN_STAGES))
                    check(fast, f"{geo} seed +-{amp} warp_bound {wb}", got, want)
            # a seed beyond the bound saturates there, with a warning
            sd = seed_of(f0.shape, 40)
            for mode in ("shipped", "fixed"):
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    got, want = (
                        om._estimate(f0, f1, sd, search, patch, mode, "exact", "sad", "auto",
                                     32, st)
                        for st in (om.KERNEL_STAGES, om.PLAIN_STAGES))
                if not any(issubclass(c.category, RuntimeWarning) and "saturates" in
                           str(c.message) for c in caught):
                    raise AssertionError("a seed beyond the bound raised no RuntimeWarning")
                check(("me_exact",), f"{geo} seed +-40 saturating bound 32 {mode}", got, want)
                if got.abs().max().item() > (40 if mode == "shipped" else 0) + 32 + sum(
                        om.me_steps(search, patch)):
                    raise AssertionError("the saturating seed's base was not clamped")
    # the round kernel alone (a median could hide a one-pixel fault), every
    # round of each geometry from a random state: widths that put column
    # w - 2 on either side of a tile edge (4 (32 - 2 pm) columns) and of a
    # warp's (32 - 2 pm), frames narrower and shorter than a tile and than a
    # patch, random content and frames of 0 against 255 (SSD differences of
    # 255^2); then the whole iteration, median included. Patches 17 and 31
    # take the kernel's unpacked SAD path.
    median_shapes = set()
    for search, patch in (ME_GEOMETRY, (9, 3), (11, 5), (21, 17), (35, 31)):
        ow = 32 - 2 * (patch // 2)
        shapes = ((2, 40, 4 * ow + 1), (1, 40, 4 * ow + 2), (1, 33, 4 * ow + 3),
                  (1, 35, 8 * ow + 2), (1, 34, ow + 1), (1, 34, ow + 2), (2, 20, 17),
                  (1, 7, 3), (1, 3, 2))
        median_shapes.update(shapes)
        for n, h, w in shapes:
            for costfn, content in (("sad", "random"), ("ssd", "random"), ("ssd", "0 and 255")):
                if content == "random":
                    f0, f1 = (torch.randint(0, 256, (n, h, w), generator=gen, device=device,
                                            dtype=torch.uint8) for _ in range(2))
                else:
                    f0 = (torch.rand((n, h, w), generator=gen, device=device) < 0.5).to(
                        torch.uint8) * 255
                    f1 = 255 - f0
                dy, dx = (torch.randint(-6, 7, (n, h, w), generator=gen, device=device,
                                        dtype=torch.int32) for _ in range(2))
                tag = f"{search}/{patch} {costfn} {content}"
                for step in om.me_steps(search, patch):
                    got = torch.stack(km.fast_round_kernel(f0, f1, dy, dx, step, patch, costfn))
                    want = torch.stack(km.fast_round(f0, f1, dy, dx, step, patch, costfn))
                    check(("me_fast_round",), f"{tag} one round, step {step}",
                          got, want.to(torch.int32))
                check(fast, f"{tag} iteration", km.me_fast_kernel(f0, f1, search, patch, costfn),
                      km.me_fast(f0, f1, search, patch, costfn))
    # the median kernel alone on the same shapes (its tile is 128 x 16
    # pixels, 4 x 2 a thread), on frames 1 pixel wide or tall, widths that
    # are not a multiple of 4 and the bench's; states in +-6, as the rounds
    # leave them, and +-2^20
    median_shapes.update({(1, 1, 1), (1, 1, 9), (1, 7, 1), (2, 1, 131), (1, 129, 1),
                          (2, 17, 130), (4, 480, 640)})
    worst = 0.0
    for n, h, w in sorted(median_shapes):
        for amp in (6, 1 << 20):
            dy, dx = (torch.randint(-amp, amp + 1, (n, h, w), generator=gen, device=device,
                                    dtype=torch.int32) for _ in range(2))
            got = torch.stack(km.median3x3_kernel(dy, dx))
            want = torch.stack([km._median3x3(dy), km._median3x3(dx)])
            torch.cuda.synchronize()
            if got.shape != want.shape or got.dtype != want.dtype:
                raise AssertionError(f"me_fast_median alone {(n, h, w)}: {tuple(got.shape)} "
                                     f"{got.dtype}")
            worst = max(worst, (got.double() - want.double()).abs().max().item())
    errs["me_fast_median"] = max(errs["me_fast_median"], worst)
    print(f"me_fast_median alone on {len(median_shapes)} shapes from {min(median_shapes)} to "
          f"{max(median_shapes)}, states +-6 and +-2^20: max|kernel - plain| = {worst}")
    # far seeds (+-200 on about 2 % of the pixels, +-3 elsewhere) and no
    # bound: the blocks that hold one cannot stage their frame-1 window and
    # read frame 1 from device memory, the others stage theirs
    f0, f1 = inputs["vga"]
    far = torch.where(torch.from_numpy(rng.random((*f0.shape, 1)) < 0.02).to(device),
                      seed_of(f0.shape, 200), seed_of(f0.shape, 3))
    for mode in ("shipped", "fixed"):
        check(("me_exact",), f"vga seeds +-200 on 2 % of pixels, no bound, {mode}",
              km.me_exact_kernel(f0, f1, *ME_GEOMETRY, "sad", far, None, mode),
              km.me_exact(f0, f1, *ME_GEOMETRY, "sad", far, None, mode))
    # phase 8's bands of a 4K pair (the pair tiled): the fast iteration on
    # each rank's rows inside the image with fast_halo_rows() of each
    # neighbour's (as _fast_residual_band runs it), the exact search on its
    # rows with exact_halo_rows() of each neighbour's, zeros beyond the image
    # (as motion_exact_sharded runs it)
    h, w = SHARD_ME
    big = [torch.from_numpy(np.ascontiguousarray(
        np.tile(f[0], (-(-h // f.shape[1]), -(-w // f.shape[2])))[:h, :w])).to(device)
        for f in (n0, n1)]
    h_loc = h // SHARD_RANKS
    hf, he = om.fast_halo_rows(*ME_GEOMETRY), om.exact_halo_rows(*ME_GEOMETRY)
    for r in range(SHARD_RANKS):
        lo, hi = max(0, r * h_loc - hf), min(h, (r + 1) * h_loc + hf)
        b0, b1 = (f[lo:hi][None].contiguous() for f in big)
        check(fast, f"4K band {r}, rows {lo}:{hi}", km.me_fast_kernel(b0, b1, *ME_GEOMETRY, "sad"),
              km.me_fast(b0, b1, *ME_GEOMETRY, "sad"))
        r0 = r * h_loc - he
        b0, b1 = (torch.zeros((1, h_loc + 2 * he, w), dtype=torch.uint8, device=device)
                  for _ in range(2))
        lo, hi = max(0, r0), min(h, r0 + b0.shape[1])
        for b, f in ((b0, big[0]), (b1, big[1])):
            b[0, lo - r0 : hi - r0] = f[lo:hi]
        check(("me_exact",), f"4K band {r}, rows {r0}:{r0 + b0.shape[1]}",
              km.me_exact_kernel(b0, b1, *ME_GEOMETRY, "sad"),
              km.me_exact(b0, b1, *ME_GEOMETRY, "sad"))
    bad = {k: v for k, v in errs.items() if v != 0.0}
    if bad:
        raise AssertionError(f"motion kernels differ from their plain versions: {bad}")
    return {k: {"max_abs_err": v} for k, v in errs.items()}


def me_main_path(rng, device):
    """Phases 4c and 5c: the motion pyramids end to end, each path with the
    launch counts set to 0 just before it and read just after; flows against
    the plain path, the numpy oracles and the ground-truth flow."""
    import numpy as np
    import torch

    from oclcomputervision_tpu_torch import ops
    from oclcomputervision_tpu_torch.kernels import _build
    from oclcomputervision_tpu_torch.ops import motion as om
    from oclcomputervision_tpu_torch.oracle import motion as oracle_motion
    from oclcomputervision_tpu_torch.oracle import pyramid as oracle_pyramid
    from oclcomputervision_tpu_torch.utils import asset_path, epe, load_gray, read_flo

    search, patch = ME_GEOMETRY
    g0, g1 = load_gray("frame10.png"), load_gray("frame11.png")
    gt = read_flo(asset_path("flow10.flo"))
    sizes = [(g0.shape[0] >> k, g0.shape[1] >> k) for k in range(ME_LEVELS - 1, -1, -1)]

    def drive(tag, kernels, a0, a1, **kw):
        torch.cuda.synchronize()
        _build.reset_launches()
        flows = ops.estimate_motion_pyramid(a0, a1, ME_LEVELS, search, patch,
                                            smooth=ME_SMOOTH, **kw)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        print(f"pyramid {tag}: {a0.shape} uint8 x2 -> "
              f"{[tuple(f.shape) for f in flows]} {flows[-1].dtype}, "
              f"launches { {k: launches[k] for k in ME_KERNELS} }")
        missing = [k for k in kernels if launches[k] < 1]
        if missing:
            raise AssertionError(f"pyramid {tag} launched no {missing} kernel")
        lead = a0.shape[:-2]
        for f, (h, w) in zip(flows, sizes):
            if tuple(f.shape) != (*lead, h, w, 2) or f.dtype != torch.float32 \
                    or f.device != device or not torch.isfinite(f).all():
                raise AssertionError(f"pyramid {tag}: bad level {tuple(f.shape)} {f.dtype}")
        t0, t1 = (torch.from_numpy(a).to(device) for a in (a0, a1))
        if t0.ndim == 2:
            t0, t1 = t0[None], t1[None]
        plain = om._pyramid(t0, t1, ME_LEVELS, search, patch, "fixed", kw["method"],
                            ME_SMOOTH, "auto", "auto", kw.get("subpixel", 0), "auto",
                            om.PLAIN_STAGES)
        for lv, (f, p) in enumerate(zip(flows, plain)):
            if not torch.equal(f.reshape(p.shape), p):
                n = (f.reshape(p.shape) != p).any(-1).sum().item()
                raise AssertionError(f"pyramid {tag} level {lv}: {n} vectors differ from "
                                     f"the plain path")
        print(f"pyramid {tag}: every level equal to the plain path")
        return flows, launches

    # the pyramid levels and the coarsest level's search against the numpy oracles
    pyr0 = ops.gaussian_pyramid(g0, 2, ME_LEVELS)
    pyr1 = ops.gaussian_pyramid(g1, 2, ME_LEVELS)
    for lv, (got, want) in enumerate(zip(pyr0, oracle_pyramid.gaussian_pyramid(g0, 2, ME_LEVELS))):
        d = np.abs(got.cpu().numpy().astype(int) - want.astype(int)).max()
        print(f"gaussian_pyramid level {lv} {tuple(got.shape)} vs numpy oracle: max {d} (<= 1)")
        if got.dtype != torch.uint8 or got.shape != want.shape or d > 1:
            raise AssertionError(f"pyramid level {lv} disagrees with the oracle")
    _build.reset_launches()
    coarse = ops.estimate_motion_vector(pyr0[0], pyr1[0], search, patch)
    want = oracle_motion.estimate_motion_vector(
        pyr0[0].cpu().numpy(), pyr1[0].cpu().numpy(), search, patch)
    same = np.array_equal(coarse.cpu().numpy(), want)
    print(f"exact search on the coarsest level {tuple(coarse.shape)} vs numpy oracle: "
          f"{'equal' if same else 'DIFFERENT'}, launches {_build.LAUNCHES['me_exact']}")
    if not same or _build.LAUNCHES["me_exact"] != 1:
        raise AssertionError("the coarsest level's exact search disagrees with the oracle")

    # each schedule on both decodes of the frames: rounded BT.601 luma (the
    # port's load_gray) and libpng's truncated luma, one level lower on half
    # the pixels, which the JAX package's EPE values were taken on
    l0, l1 = load_gray("frame10.png", libpng=True), load_gray("frame11.png", libpng=True)
    print(f"libpng decode differs from the rounded one on {(l0 != g0).mean():.4f} of frame10, "
          f"by at most {np.abs(l0.astype(int) - g0).max()}")
    results, rounded, launches = {}, {}, {}
    for name, kw in ME_SCHEDULES.items():
        kernels = ME_KERNELS if kw["method"] == "fast" else ("me_exact",)
        flows, launches[name] = drive(f"{name}, libpng luma", kernels, l0, l1, **kw)
        results[name] = epe(flows[-1].cpu().numpy(), gt)
        integer = bool((flows[-1] == flows[-1].round()).all())
        if integer != ("subpixel" not in kw):
            raise AssertionError(f"pyramid {name}: integer-valued flow is {integer}")
        flows, _ = drive(f"{name}, rounded luma", kernels, g0, g1, **kw)
        rounded[name] = epe(flows[-1].cpu().numpy(), gt)
    bound = ops.exact_flow_bound(ME_LEVELS, search, patch)
    b0, b1 = noisy_pairs(rng, ME_PYRAMID_BATCH)
    for name in ("exact", "hybrid"):
        kw = ME_SCHEDULES[name]
        kernels = ME_KERNELS if kw["method"] == "fast" else ("me_exact",)
        flows, launches[f"batched {name}"] = drive(f"batched {name}", kernels, b0, b1, **kw)
        if name == "exact" and flows[-1].abs().max().item() > bound:
            raise AssertionError(f"exact pyramid flow beyond exact_flow_bound = {bound}")

    # phase 5c: quality
    zero = epe(np.zeros_like(gt), gt)
    print(f"EPE on flow10.flo, finest level (zero flow {zero:.4f}):")
    for name, val in results.items():
        print(f"    {name:16s} {val:.4f} px on libpng luma (the JAX package's "
              f"{EPE_TARGETS[name]:.3f}, tol {EPE_TOL}); {rounded[name]:.4f} px on rounded luma")
    off = {k: v for k, v in results.items() if not abs(v - EPE_TARGETS[k]) <= EPE_TOL}
    if off or not all(v < zero for v in (*results.values(), *rounded.values())):
        raise AssertionError(f"EPE off its target: {off} (zero flow {zero})")
    # the hybrid schedule on the 4-pair batch launches all three kernels
    results.update({f"{k}, rounded luma": v for k, v in rounded.items()})
    return {k: launches["batched hybrid"][k] for k in ME_KERNELS}, results, (b0, b1)


def wall_ms(fn, *args, warmup: int = 2, iters: int = 5) -> float:
    """Median host milliseconds of ``fn(*args)`` ending in a synchronise."""
    import statistics

    import torch

    for _ in range(warmup):
        fn(*args)
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def me_timing(rng, pyramid_batch, card, device):
    """Phase 6c: the searches' and pyramids' rates through the kernels and
    the plain versions, the pyramids' profiles, and each kernel's own time
    at the 4-pair finest level beside its bound."""
    import torch

    from oclcomputervision_tpu_torch import ops
    from oclcomputervision_tpu_torch.kernels import motion as km
    from oclcomputervision_tpu_torch.ops import motion as om
    from oclcomputervision_tpu_torch.utils import cuda_time_ms, device_profile, load_gray

    search, patch = ME_GEOMETRY
    steps = om.me_steps(search, patch)

    def on_card(*arrays):
        return tuple(torch.from_numpy(a).to(device) for a in arrays)

    def single(method, stages, t0, t1):
        return om._estimate(t0, t1, None, search, patch, "shipped", method, "sad", "auto",
                            "auto", stages)

    def pyramid(method, stages, t0, t1):
        return om._pyramid(t0, t1, ME_LEVELS, search, patch, "fixed", method, ME_SMOOTH,
                           "auto", "auto", 0, "auto", stages)

    e2e = {}
    for name, method, n in (("me_exact", "exact", ME_EXACT_BATCH),
                            ("me_fast", "fast", ME_FAST_BATCH)):
        t0, t1 = on_card(*noisy_pairs(rng, n))
        mp = t0.numel() / 1e6
        ms_k = cuda_time_ms(ops.estimate_motion_vector, t0, t1, search, patch, None,
                            "shipped", method)
        ms_p = cuda_time_ms(single, method, om.PLAIN_STAGES, t0, t1)
        print(f"[{card}] e2e estimate_motion_vector {method} {tuple(t0.shape)} uint8 x2 "
              f"kernels: {ms_k:.4f} ms, {mp / ms_k * 1e3:.2f} MP in/s; plain: {ms_p:.4f} ms, "
              f"{mp / ms_p * 1e3:.2f} MP in/s")
        e2e[name] = {"ms": ms_k, "plain_ms": ms_p, "mp_in_per_s": mp / ms_k * 1e3,
                     "plain_mp_in_per_s": mp / ms_p * 1e3}
        del t0, t1

    b0, b1 = on_card(*pyramid_batch)
    mp = b0.numel() / 1e6
    ms_k = cuda_time_ms(pyramid, "exact", om.KERNEL_STAGES, b0, b1)
    ms_p = cuda_time_ms(pyramid, "exact", om.PLAIN_STAGES, b0, b1)
    print(f"[{card}] e2e exact pyramid {tuple(b0.shape)} uint8 x2, {ME_LEVELS} levels, smooth "
          f"{ME_SMOOTH}, kernels: {ms_k:.4f} ms, {mp / ms_k * 1e3:.2f} finest-level MP/s; "
          f"plain: {ms_p:.4f} ms, {mp / ms_p * 1e3:.2f} MP/s")
    e2e["me_pyramid_batched_exact"] = {"ms": ms_k, "plain_ms": ms_p,
                                       "mp_per_s": mp / ms_k * 1e3,
                                       "plain_mp_per_s": mp / ms_p * 1e3}

    g0, g1 = on_card(load_gray("frame10.png")[None], load_gray("frame11.png")[None])
    for name, method in (("exact", "exact"), ("hybrid", "fast")):
        ms_k = wall_ms(pyramid, method, om.KERNEL_STAGES, g0, g1)
        ms_p = wall_ms(pyramid, method, om.PLAIN_STAGES, g0, g1)
        per_kernel, idle = device_profile(pyramid, method, om.KERNEL_STAGES, g0, g1)
        busy = sum(per_kernel.values())
        print(f"[{card}] single-pair {name} pyramid 480x640, {ME_LEVELS} levels, smooth "
              f"{ME_SMOOTH}: wall {ms_k:.4f} ms through the kernels, {ms_p:.4f} ms through "
              f"the plain versions; torch.profiler device ms per call {busy:.4f} "
              f"(idle share {idle:.4f}):")
        for kname, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]:
            print(f"    {ms:9.4f}  {kname[:90]}")
        e2e[f"me_pyramid_{name}"] = {"wall_ms": ms_k, "plain_wall_ms": ms_p,
                                     "device_ms": busy, "idle_share": idle}

    # the torch-op steps of a level, at the finest level of one pair
    flow = pyramid("exact", om.KERNEL_STAGES, g0, g1)
    for k in (5, ME_SMOOTH):
        print(f"[{card}] median_filter_flow k={k} on {tuple(flow[-1].shape)}: "
              f"{cuda_time_ms(om.median_filter_flow, flow[-1], k):.4f} ms")
    print(f"[{card}] upscale_mv x2 'fixed' on {tuple(flow[-2].shape)}: "
          f"{cuda_time_ms(om.upscale_mv, flow[-2], 2, 'fixed'):.4f} ms; refine_flow_subpixel "
          f"on {tuple(flow[-1].shape)}: "
          f"{cuda_time_ms(om._refine_subpixel, g0, g1, flow[-1], patch, 'sad'):.4f} ms; "
          f"gaussian_pyramid of one frame: "
          f"{cuda_time_ms(ops.gaussian_pyramid, g0, 2, ME_LEVELS, True):.4f} ms")

    # each kernel at the finest level of the 4-pair pyramid, seeded as there
    seed = om.upscale_mv(pyramid("exact", om.KERNEL_STAGES, b0, b1)[-2], 2, "fixed")
    sb = om._quantum(om._base_max(seed))
    base_y, base_x = km._seed_base(seed, None)
    ys, xs = km._grid(b0.shape[1], b0.shape[2], device)
    base1 = km.gather_padded(b1, ys + base_y, xs + base_x).contiguous()
    out = km.me_exact_kernel(b0, b1, search, patch, "sad", seed, sb, "fixed")
    px = b0.numel()
    exact = (lambda: km.me_exact_kernel(b0, b1, search, patch, "sad", seed, sb, "fixed"),
             lambda: km.me_exact(b0, b1, search, patch, "sad", seed, sb, "fixed"))
    fast = (lambda: km.me_fast_kernel(b0, base1, search, patch, "sad"),
            lambda: km.me_fast(b0, base1, search, patch, "sad"))
    n = len(steps)
    pairs = {
        "me_exact": (*exact, nbytes(b0, b1, seed, out), px),
        # per call n launches: both frames and the int32 state pair read (no
        # state in the first round), the new state pair written
        "me_fast_round": (*fast, n * nbytes(b0, base1) + (2 * n - 1) * 8 * px, n * px),
        # per call n launches: a state pair read, a state pair or the flow written
        "me_fast_median": (*fast, 2 * n * 8 * px, n * px),
    }
    shape = "x".join(str(d) for d in b0.shape)
    times = {}
    for name, (fk, fp, moved, elems) in pairs.items():
        ms, call_ms, pms = kernel_ms(name, fk), cuda_time_ms(fk), cuda_time_ms(fp)
        bms, by = bound(name, moved, elems)
        times[name] = {"ms": ms, "call_ms": call_ms, "plain_ms": pms, "bound_ms": bms,
                       "bound_by": by, "library_ms": None,
                       "cold_l2_ms": kernel_ms(name, fk, cold_l2=True)}
        if name == "me_fast_round":
            # the bound by the tap-by-tap count, which earlier records give
            times[name]["tap_count_bound_ms"] = 9 * 25 * 3 * elems / F32_OPS_PER_S * 1e3
        what = (f"seeded, bound {sb}" if name == "me_exact" else
                f"{n} launches per call; whole call and plain: the {n}-round iteration")
        print(f"[{card}] {name} at {shape} ({what}): kernel {ms:.4f} ms (whole call "
              f"{call_ms:.4f} ms; {times[name]['cold_l2_ms']:.4f} ms with L2 flushed before "
              f"each call), plain {pms:.4f} ms, bound {bms:.4f} ms ({by}: "
              f"{moved / 1e6:.1f} MB), library none")
    t0, t1 = on_card(*noisy_pairs(rng, ME_EXACT_BATCH))
    ms = kernel_ms("me_exact", lambda: km.me_exact_kernel(t0, t1, search, patch))
    bms, by = bound("me_exact", nbytes(t0, t1, km.me_exact_kernel(t0, t1, search, patch)),
                    t0.numel())
    print(f"[{card}] me_exact at {tuple(t0.shape)} unseeded: kernel {ms:.4f} ms, "
          f"{t0.numel() / 1e6 / ms * 1e3:.2f} MP/s, bound {bms:.4f} ms ({by})")
    times["me_exact"].update(unseeded_ms=ms, unseeded_bound_ms=bms)
    return times, e2e


# ---------------------------------------------------------------------------
# Phases 7-7e: resize, RAISR 'shipped', the trainer, EnhancePipeline, compat
# ---------------------------------------------------------------------------

RESIZE_METHODS = ("bilinear", "bicubic")
RESIZE_MAPPINGS = ("align_corners", "hw_sampler", "half_pixel")
RESIZE_STACK = (3, 256, 320)  # the [B, H, W] luma stack phase 7 checks
RESIZE_BENCH = (16, 1024, 1024)  # bench.py:378's batch: 1024^2 -> 2048^2 uint8
# enhance_720p.batch16's resize: its RAISR x2 output, 1440 x 2560, to 1080p
RESIZE_CELL = (16, 1440, 2560, (1080, 1920))
RESIZE_CPU_SHARE = 0.9999  # card vs CPU: equal, or within one level on this share
RESIZE_FLOAT_TOL = 1e-4  # float resize, card vs CPU, on the [0, 255] scale
# frame11 x2 PSNR (dB) of the JAX package's train_filters on train_corpus() at
# RaisrConfig() with augment='starved', upsampled by the JAX raisr_upsample on
# the CPU; recorded by `python tests/test_torch_raisr_train.py` (its
# record_frame11), the port's PNG decode of every image
JAX_TRAINED_FRAME11_DB = 34.260951392846586
TRAINED_DB_TOL = 0.05
TRAIN_GR_TOL = 1e-4  # per-bucket G and r, card features vs plain, of the bucket's max |G|
PIPE_SHAPE = (16, 768, 1280)  # EnhancePipeline's input: lenna tiles
PIPE_CHECK = 2  # images held against device="cpu"
PIPE_RESIZE = (1080, 1920)
PIPE_DEPTH = 3
COMPAT_RAISR_PSNR = 40.0  # dB, RAISR against the numpy oracle (ROADMAP north star)


def _within_one(a, b) -> float:
    """Share of values of two uint8 tensors (any devices) within one level."""
    return ((a.cpu().int() - b.cpu().int()).abs() <= 1).float().mean().item()


def _no_launches(tag: str) -> None:
    from oclcomputervision_tpu_torch.kernels import _build

    if any(_build.LAUNCHES.values()):
        raise AssertionError(f"{tag} launched kernels: {dict(_build.LAUNCHES)}")


def _launched_once(tag: str, kernel: str, fn, *args, **kw):
    """``fn(*args, **kw)`` on the card, which must launch ``kernel`` once and
    no other kernel of the library."""
    import torch

    from oclcomputervision_tpu_torch.kernels import _build

    torch.cuda.synchronize()
    _build.reset_launches()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    seen = {k: v for k, v in _build.LAUNCHES.items() if v}
    if seen != {kernel: 1}:
        raise AssertionError(f"{tag} launched {seen}, not {kernel} once")
    return out


def _bits_equal(a, b) -> bool:
    """Two tensors of one dtype and shape, equal bit for bit (f32 by its bits)."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def plain_resize(x, out_hw, method, mapping="align_corners", batched=None, out_dtype=None):
    """``ops.resize`` (f32 out) or ``ops.resize_uint8`` (``out_dtype`` uint8)
    of a tensor on its own device through the plain passes
    (``ops.interpolation._resize_passes``): what the CPU path computes."""
    import torch

    from oclcomputervision_tpu_torch.ops import interpolation as interp

    x4, unpack = interp._channels_last(x.to(torch.float32), batched)
    out = interp._resize_passes(x4, out_hw, method, mapping)
    if method == "bicubic":
        out = torch.clamp(out, 0.0, 1.0 if x.dtype.is_floating_point else 255.0)
    if out_dtype == torch.uint8:
        out = torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
    return unpack(out)


def resize_phase(rng, card, device):
    """Phase 7: ``ops.resize_uint8`` and ``ops.resize`` on the card through
    the resize kernel (``kernels/csrc/resize_sep.cu``), bilinear and bicubic
    under the three mappings, on gray lenna, RGB lenna and a [B, H, W]
    stack, up and down, and on float input: each call one launch, equal bit
    for bit to the plain passes on the same card tensor, and held against
    the same calls with device="cpu" and the numpy oracle; the enhance
    cell's 16 x 1440 x 2560 -> 1080 x 1920 bicubic and a ``_raisr_shipped``
    band (its row table rebased) the same way; then the kernel's own time
    at the cell's shape and at RESIZE_BENCH beside its bytes bound, the
    plain passes and F.interpolate (a yardstick: another function).
    Returns (phase record, the kernel's checks, its times, its launches)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from oclcomputervision_tpu_torch import ops
    from oclcomputervision_tpu_torch.ops import interpolation as interp
    from oclcomputervision_tpu_torch.ops import raisr as ops_raisr
    from oclcomputervision_tpu_torch.oracle import interpolation as oracle
    from oclcomputervision_tpu_torch.utils import cuda_time_ms, load_gray, load_image

    u8 = torch.uint8
    inputs = {"gray lenna": (load_gray("lenna.png"), None), "RGB lenna": (load_image("lenna.png"), None),
              "luma stack": (lenna_batch(rng, *RESIZE_STACK), True)}
    worst = {"cpu_share": 1.0, "cpu_float_err": 0.0, "oracle_max": 0}
    calls = 0

    def both(tag, x, out_hw, method, mapping="align_corners", batched=None, out_dtype=torch.float32):
        nonlocal calls
        fn = ops.resize_uint8 if out_dtype == u8 else ops.resize
        got = _launched_once(tag, "resize_sep", fn, x, out_hw, method, mapping, batched=batched)
        want = plain_resize(x, out_hw, method, mapping, batched, out_dtype)
        calls += 1
        if not _bits_equal(got, want):
            diff = (got.double() - want.double()).abs().max().item()
            raise AssertionError(f"resize {tag}: the kernel differs from the plain passes "
                                 f"(max |diff| {diff})")
        return got

    for tag, (img, batched) in inputs.items():
        h, w = img.shape[1:3] if batched else img.shape[:2]
        x = torch.from_numpy(img).to(device)
        for size, out_hw in (("up", (2 * h, 2 * w)), ("down", (3 * h // 8, 5 * w // 8))):
            for method in RESIZE_METHODS:
                for mapping in RESIZE_MAPPINGS:
                    args = (out_hw, method, mapping)
                    case = f"{tag} {size} {method} {mapping}"
                    got = both(case, x, *args, batched=batched, out_dtype=u8)
                    got_f = both(case + " f32", x, *args, batched=batched)
                    cpu = ops.resize_uint8(img, *args, batched=batched, device="cpu")
                    share = _within_one(got, cpu)
                    ferr = (got_f.cpu() - ops.resize(img, *args, batched=batched, device="cpu")
                            ).abs().max().item()
                    imgs = list(img) if batched else [img]
                    want = np.stack([oracle.resize_uint8(i, *args) for i in imgs])
                    omax = int(np.abs(got.cpu().numpy().reshape(want.shape).astype(int)
                                      - want.astype(int)).max())
                    worst["cpu_share"] = min(worst["cpu_share"], share)
                    worst["cpu_float_err"] = max(worst["cpu_float_err"], ferr)
                    worst["oracle_max"] = max(worst["oracle_max"], omax)
                    if share < RESIZE_CPU_SHARE or ferr > RESIZE_FLOAT_TOL or omax > 1:
                        raise AssertionError(
                            f"resize {case}: {share} within one level of the CPU, float {ferr}, "
                            f"oracle max {omax}")
    cases = len(inputs) * 2 * len(RESIZE_METHODS) * len(RESIZE_MAPPINGS)
    # float input (read as f32), a strong downscale (the direct form) and odd
    # widths; rows of 77 and 308 bytes (not 16-byte multiples: the kernel's
    # element-wise staging)
    g01 = torch.from_numpy(load_gray("lenna.png")).to(device).float() / torch.tensor(255.0, device=device)
    odd = torch.from_numpy(lenna_batch(rng, 2, 101, 77)).to(device)
    for method in RESIZE_METHODS:
        for out_hw in ((1031, 997), (67, 45), (301, 13)):
            both(f"float gray -> {out_hw} {method}", g01, out_hw, method)
            both(f"float gray -> {out_hw} {method} uint8", g01, out_hw, method, out_dtype=u8)
        for x, tag in ((odd, "uint8"), (odd.float() / torch.tensor(255.0, device=device), "float")):
            for out_hw in ((203, 151), (60, 50)):
                both(f"{tag} 2 x 101 x 77 -> {out_hw} {method}", x, out_hw, method, batched=True,
                     out_dtype=u8)

    # the enhance cell's resize: RAISR x2 of 720p to 1080p, bicubic, uint8
    n, h, w, out_hw = RESIZE_CELL
    cell = torch.randint(0, 256, (n, h, w), dtype=u8, device=device)
    both(f"enhance cell {(n, h, w)} -> {out_hw}", cell, out_hw, "bicubic", batched=True, out_dtype=u8)

    # fidelity='shipped' on a band: f32 input, bilinear x2, the band's row table
    band = torch.from_numpy(lenna_batch(rng, 1, 96, 160)[..., None]).to(device)
    h_img, row0 = 256, 37
    got = _launched_once("_raisr_shipped band", "resize_sep", ops_raisr._raisr_shipped, band, 2,
                         True, row0, h_img)
    kernel_plane = ops_raisr._resize_plane
    ops_raisr._resize_plane = interp._resize_passes  # the same call through the plain passes
    try:
        want = ops_raisr._raisr_shipped(band, 2, True, row0, h_img)
    finally:
        ops_raisr._resize_plane = kernel_plane
    calls += 1
    if not _bits_equal(got, want):
        raise AssertionError("resize: _raisr_shipped's band through the kernel differs from the passes")
    print(f"resize: {cases} cases (gray, RGB, a {RESIZE_STACK} stack; up and down; bilinear and "
          f"bicubic under {', '.join(RESIZE_MAPPINGS)}; uint8 and f32 out), float input at 3 sizes "
          f"each way, 77-pixel rows, the enhance cell's {(n, h, w)} -> {out_hw} bicubic and a _raisr_shipped band: "
          f"{calls} calls, each one resize_sep launch and equal bit for bit to the plain passes on "
          f"the card; card vs CPU uint8 within one level on >= {worst['cpu_share']:.7f} (min "
          f"{RESIZE_CPU_SHARE}), float max |diff| {worst['cpu_float_err']:.3e} (max "
          f"{RESIZE_FLOAT_TOL}); vs numpy oracle max {worst['oracle_max']} level (max 1)")

    timings = {}
    rows = {"cell": (cell, out_hw, ("bicubic",)),
            "bench": (torch.randint(0, 256, RESIZE_BENCH, dtype=u8, device=device),
                      (2 * RESIZE_BENCH[1], 2 * RESIZE_BENCH[2]), RESIZE_METHODS)}
    for where, (x, hw, methods) in rows.items():
        mp_out = x.shape[0] * hw[0] * hw[1] / 1e6
        for method in methods:
            def kernel(m=method, x=x, hw=hw):
                return ops.resize_uint8(x, hw, m, batched=True)

            def lib(m=method, x=x, hw=hw):
                y = F.interpolate(x[:, None].float(), size=hw, mode=m, align_corners=True)
                return torch.clamp(torch.round(y), 0, 255).to(u8)

            kms = kernel_ms("resize_sep", kernel)
            # per output, 2 x taps products and sums of the column pass and as many of the row pass
            taps = 4 if method == "bicubic" else 2
            bms, by = bound("resize_sep", x.numel() + x.shape[0] * hw[0] * hw[1],
                            x.shape[0] * hw[0] * hw[1], ops=4 * taps)
            pms = cuda_time_ms(plain_resize, x, hw, method, "align_corners", True, u8)
            lms = cuda_time_ms(lib)
            timings[f"{where} {method}"] = {
                "shape": [*x.shape, *hw], "kernel_ms": kms, "bound_ms": bms, "bound_by": by,
                "roofline_share": bms / kms, "mp_out_per_s": mp_out / kms * 1e3,
                "plain_ms": pms, "library_ms": lms}
            print(f"[{card}] resize_sep {method} uint8 {tuple(x.shape)} -> {hw}: kernel {kms:.4f} ms, "
                  f"{mp_out / kms * 1e3:.2f} MP out/s, bound {bms:.4f} ms ({by}; "
                  f"{100 * bms / kms:.1f} %); plain passes {pms:.4f} ms; F.interpolate(mode="
                  f"{method!r}, align_corners=True) + round {lms:.4f} ms (a yardstick, not the "
                  f"port: {'a = -0.75' if method == 'bicubic' else 'f32 coordinates'})")
    cell_t = timings["cell bicubic"]
    checks = {"max_abs_err": 0.0, "cases": calls}
    times = {"ms": cell_t["kernel_ms"], "bound_ms": cell_t["bound_ms"], "plain_ms": cell_t["plain_ms"],
             "library_ms": cell_t["library_ms"], "bench": timings}
    return {**worst, "calls": calls, "bench": timings}, checks, times, calls


def shipped_phase(device):
    """Phase 7b: RaisrModel.load(x2 bank, fidelity='shipped').upsample on
    gray, RGB and BGRA lenna, on the card against device="cpu": the bilinear
    upscale (one resize_sep launch) and the YUV round trip."""
    import numpy as np
    import torch

    from oclcomputervision_tpu_torch.kernels import _build
    from oclcomputervision_tpu_torch.models.raisr import RaisrModel
    from oclcomputervision_tpu_torch.utils import asset_path, load_gray, load_image

    path = asset_path("raisr_filters_x2.npz")
    card = RaisrModel.load(path, fidelity="shipped", device=device)
    cpu = RaisrModel.load(path, fidelity="shipped", device="cpu")
    rgb = load_image("lenna.png")
    alpha = np.random.default_rng(7).integers(0, 256, rgb.shape[:2], dtype=np.uint8)
    bgra = np.ascontiguousarray(np.concatenate([rgb[..., ::-1], alpha[..., None]], -1))
    shares = {}
    for tag, img in (("gray", load_gray("lenna.png")), ("RGB", rgb), ("BGRA", bgra)):
        got = _launched_once(f"shipped {tag}", "resize_sep", card.upsample, img)
        want = cpu.upsample(img)
        shares[tag] = _within_one(got, want)
        print(f"RAISR shipped {tag}: {img.shape} -> {tuple(got.shape)} uint8, "
              f"{shares[tag]:.7f} of values within one level of device='cpu' (min {E2E_WITHIN_ONE}); "
              f"one resize_sep launch")
        if tuple(got.shape) != tuple(want.shape) or shares[tag] < E2E_WITHIN_ONE:
            raise AssertionError(f"shipped {tag}: card and CPU disagree ({shares[tag]})")
    return shares


def trainer_phase(card, device):
    """Phase 7c: the RAISR trainer at the shipped x2 model's full width
    (RaisrConfig(): 864 filters of 11 x 11) on train_corpus(), augment='starved'.
    (a) the card's features (the upscale and hash kernels) against the plain
    versions on the card, on lenna; (b) the launch counts, the frame11 PSNR
    against bicubic and the recorded JAX figure; (c) the times by stage."""
    import numpy as np
    import torch

    from oclcomputervision_tpu_torch import ops
    from oclcomputervision_tpu_torch.kernels import _build
    from oclcomputervision_tpu_torch.models.raisr import (
        RIDGE_BY_SCALE,
        RaisrModel,
        _training_arrays,
        accumulate_normal_eq,
        dihedral_transforms,
        hr_luma01,
        solve_filters,
        train_filters,
    )
    from oclcomputervision_tpu_torch.ops.raisr import KERNEL_STAGES, PLAIN_STAGES
    from oclcomputervision_tpu_torch.utils import asset_path, load_gray, psnr
    from oclcomputervision_tpu_torch.utils.config import RaisrConfig

    # a TF32 matmul or solve would move the bank (cond(G) ~ 1e7) far past any tolerance
    if torch.get_float32_matmul_precision() != "highest" or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("float32 matmuls are not at full precision")
    cfg = RaisrConfig()
    corpus = train_corpus()

    # (a) features through the kernels and through the plain versions, on the card
    y = torch.from_numpy(hr_luma01(corpus[0]).astype(np.float32)).to(device)
    pk, tk, fk = _training_arrays(y, cfg, KERNEL_STAGES)
    pp, tp, fp = _training_arrays(y, cfg, PLAIN_STAGES)
    agree = (fk == fp).float().mean().item()
    ulp = torch.nextafter(pp.abs(), torch.tensor(float("inf"), device=device)) - pp.abs()
    patches_ok = bool(((pk - pp).abs() <= ulp).all()) and torch.equal(tk, tp)
    nf = cfg.num_filters
    gk, rk, ck = accumulate_normal_eq(pk, tk, fk, nf)
    gp, rp, cp = accumulate_normal_eq(pp, tp, fp, nf)
    differ = fk != fp
    touched = torch.zeros(nf, dtype=torch.bool, device=device)
    touched[fk[differ].long()] = True
    touched[fp[differ].long()] = True
    gmax = gp.abs().amax(dim=(1, 2)).clamp_min(torch.finfo(torch.float32).tiny)
    keep = ~touched & (cp > 0)
    g_err = ((gk - gp).abs().amax(dim=(1, 2)) / gmax)[keep].max().item()
    r_err = ((rk - rp).abs().amax(dim=1) / gmax)[keep].max().item()
    counts_ok = not bool(((ck != cp) & ~touched).any())
    print(f"trainer features on lenna {tuple(y.shape)}, card vs plain on the card: fidx "
          f"agreement {agree:.7f} (min {HASH_AGREEMENT}, {int(differ.sum())} differ), patches "
          f"within 1 f32 ULP {patches_ok}, per-bucket G {g_err:.3e} and r {r_err:.3e} of the "
          f"bucket's max |G| (max {TRAIN_GR_TOL}, buckets a differing pixel touches left out), "
          f"counts differ only there {counts_ok}")
    if agree < HASH_AGREEMENT or not patches_ok or not counts_ok or max(g_err, r_err) > TRAIN_GR_TOL:
        raise AssertionError("the trainer's features through the kernels disagree with the plain versions")
    del pk, pp, gk, rk, ck

    # (b): the whole trainer through the kernels
    def on_events(fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end)

    _build.reset_launches()
    bank, wall = on_events(lambda: train_filters(corpus, cfg, augment="starved", device=device))
    launches = dict(_build.LAUNCHES)
    variants = [v for im in corpus for v in dihedral_transforms(hr_luma01(im))]
    hr_mp = sum((v.shape[0] // 2 * 2) * (v.shape[1] // 2 * 2) for v in variants) / 1e6
    print(f"trainer: {len(corpus)} images ({', '.join(str(im.shape) for im in corpus)}) x 8 "
          f"dihedral variants, {hr_mp:.4f} HR MP, launches {launches}")
    if launches["upscale_planes"] < 1 or launches["raisr_hash"] < 1:
        raise AssertionError("the trainer's features launched no upscale or hash kernel")
    if not bool(torch.isfinite(bank).all()) or tuple(bank.shape) != (nf, 11, 11):
        raise AssertionError(f"bank {tuple(bank.shape)} not finite")

    # (c): its three stages, each run again alone over the corpus as
    # train_filters(augment='starved') runs them; the bank they make must be
    # the trainer's, bit for bit (the accumulation uses no atomics)
    feats, ms_f = on_events(lambda: [_training_arrays(torch.from_numpy(
        np.ascontiguousarray(v, np.float32)).to(device), cfg) for v in variants])

    def accumulate():
        sums = [torch.zeros_like(t) for t in (gp, rp, cp)]
        native = [torch.zeros_like(t) for t in (gp, rp, cp)]
        for k, f in enumerate(feats):
            part = accumulate_normal_eq(*f, nf)
            sums = [a + b for a, b in zip(sums, part)]
            if k % 8 == 0:  # the identity transform comes first
                native = [a + b for a, b in zip(native, part)]
        return sums, native

    (sums, native), ms_a = on_events(accumulate)
    ridge = RIDGE_BY_SCALE[cfg.scale]

    def solve():
        f_all = solve_filters(*sums, cfg.filter_len, ridge)
        f_nat = solve_filters(*native, cfg.filter_len, ridge)
        return torch.where((native[2] < 2.0 * cfg.filter_len ** 2)[:, None, None], f_all, f_nat)

    staged, ms_s = on_events(solve)
    stages = {"features": ms_f, "accumulate": ms_a, "solve": ms_s}
    print(f"[{card}] trainer: {wall:.4f} ms wall; its stages run alone: features {ms_f:.4f}, "
          f"accumulate {ms_a:.4f}, solve {ms_s:.4f} ms; G/r accumulation "
          f"{hr_mp / ms_a * 1e3:.4f} HR MP/s; the stages' bank equal to the trainer's "
          f"{torch.equal(staged, bank)}")
    if not torch.equal(staged, bank):
        raise AssertionError("the trainer's bank differs from run to run")
    del feats, sums, native, gp, rp, cp

    hr, lr = degrade(load_gray("frame11.png"), 2)
    trained = RaisrModel(cfg, bank).upsample(lr).cpu().numpy()
    shipped = RaisrModel.load(asset_path("raisr_filters_x2.npz"), device=device).upsample(lr)
    bicubic = ops.resize_uint8(lr, hr.shape, "bicubic", device=device)
    p_t, p_s, p_b = psnr(trained, hr), psnr(shipped.cpu().numpy(), hr), psnr(bicubic.cpu().numpy(), hr)
    print(f"[{card}] frame11 x2 PSNR: card-trained bank {p_t:.4f} dB (JAX-trained on the CPU "
          f"{JAX_TRAINED_FRAME11_DB:.4f}, max off {TRAINED_DB_TOL}), shipped bank {p_s:.4f} dB, "
          f"bicubic {p_b:.4f} dB")
    if not p_t > p_b or abs(p_t - JAX_TRAINED_FRAME11_DB) > TRAINED_DB_TOL:
        raise AssertionError(f"the card-trained bank: {p_t} dB (bicubic {p_b})")
    return {"launches": launches, "wall_ms": wall, "stages_ms": stages,
            "gr_mp_per_s": hr_mp / ms_a * 1e3, "fidx_agreement": agree,
            "psnr_db": p_t, "shipped_db": p_s, "bicubic_db": p_b}


def pipeline_phase(rng, card, device):
    """Phase 7d: EnhancePipeline, global equalize -> RAISR x2 (the shipped
    bank) -> bicubic resize to PIPE_RESIZE -> a PIPE_DEPTH pyramid, on
    PIPE_SHAPE lenna tiles: launch counts, PIPE_CHECK images against
    device="cpu", input MP/s; then equalize='local' on 2 images, untimed."""
    import torch

    from oclcomputervision_tpu_torch import ops
    from oclcomputervision_tpu_torch.kernels import _build
    from oclcomputervision_tpu_torch.models import EnhanceConfig, EnhancePipeline, RaisrModel
    from oclcomputervision_tpu_torch.utils import asset_path, cuda_time_ms, device_profile

    model = RaisrModel.load(asset_path("raisr_filters_x2.npz"), device=device)
    x = torch.from_numpy(lenna_batch(rng, *PIPE_SHAPE)).to(device)
    few = x[:PIPE_CHECK].cpu().numpy()
    res = {}
    for equalize in ("global", "local"):
        cfg = EnhanceConfig(equalize=equalize, superres="raisr", resize_to=PIPE_RESIZE,
                            resize_method="bicubic", pyramid_depth=PIPE_DEPTH)
        pipe = EnhancePipeline(cfg, raisr_model=model)
        inp = x if equalize == "global" else x[:2]
        torch.cuda.synchronize()
        _build.reset_launches()
        out, levels = pipe(inp)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        need = ((GLOBAL_KERNELS if equalize == "global" else LOCAL_KERNELS) + RAISR_KERNELS
                + ("resize_sep",))
        missing = [k for k in need if launches[k] < 1]
        print(f"EnhancePipeline equalize={equalize!r}: {tuple(inp.shape)} uint8 -> "
              f"{tuple(out.shape)} and levels {[tuple(v.shape) for v in levels]}, launches {launches}")
        if missing or tuple(out.shape) != (inp.shape[0], *PIPE_RESIZE):
            raise AssertionError(f"pipeline {equalize}: launched no {missing}, or output {tuple(out.shape)}")
        # the equalized stage equal to the CPU's; the rest within one level
        eq = EnhanceConfig(equalize=equalize)
        eq_card = EnhancePipeline(eq)(inp[:PIPE_CHECK])
        if not torch.equal(eq_card.cpu(), EnhancePipeline(eq)(few, device="cpu")):
            raise AssertionError(f"pipeline {equalize}: the equalized stage differs from the CPU's")
        if equalize == "global":
            cpu_out, cpu_levels = pipe(few, device="cpu")
            shares = [_within_one(out[:PIPE_CHECK], cpu_out)] + [
                _within_one(a[:PIPE_CHECK], b) for a, b in zip(levels, cpu_levels)]
            print(f"EnhancePipeline vs device='cpu' on {PIPE_CHECK} images: equalized stage equal, "
                  f"output and levels within one level on {', '.join(f'{s:.7f}' for s in shares)} "
                  f"(min {E2E_WITHIN_ONE})")
            if min(shares) < E2E_WITHIN_ONE:
                raise AssertionError(f"pipeline: card and CPU disagree ({shares})")
            ms = cuda_time_ms(pipe, x)
            mp_in = x.numel() / 1e6
            per_kernel, idle = device_profile(pipe, x)
            # each stage alone on the previous stage's output (CUDA events)
            eq_x = ops.histeq_global(x)
            sr = model.upsample(eq_x)
            rs = ops.resize_uint8(sr, PIPE_RESIZE, "bicubic", batched=True)
            stages = {"equalize": cuda_time_ms(ops.histeq_global, x),
                      "raisr": cuda_time_ms(model.upsample, eq_x),
                      "resize": cuda_time_ms(lambda: ops.resize_uint8(
                          sr, PIPE_RESIZE, "bicubic", batched=True)),
                      "pyramid": cuda_time_ms(lambda: ops.gaussian_pyramid(
                          rs, 2, PIPE_DEPTH, batched=True))}
            print(f"[{card}] EnhancePipeline {tuple(x.shape)}: {ms:.4f} ms, "
                  f"{mp_in / ms * 1e3:.2f} MP in/s; device busy {sum(per_kernel.values()):.4f} "
                  f"ms, idle share {idle:.4f}; stages alone: " + ", ".join(
                      f"{k} {v:.4f} ms" for k, v in stages.items()))
            res[equalize] = {"launches": launches, "ms": ms, "mp_in_per_s": mp_in / ms * 1e3,
                             "device_ms": sum(per_kernel.values()), "idle_share": idle,
                             "stages_ms": stages, "cpu_within_one": shares}
        else:
            res[equalize] = {"launches": launches}
    return res


TRACE_LOOPS = 10  # phase 7g's loops each way
TRACE_CALLS = 32  # calls per loop: two sampled ones in each
CELL_SHAPES = {"raisr_x2": (16, 1024, 1024), "enhance_720p": (16, 720, 1280)}
# the syncs each span of one call must count
CELL_SYNCS = {"raisr_x2": {"ocv.raisr.in": 1},
              "enhance_720p": {"ocv.equalize": 1, "ocv.raisr.in": 1}}


def _syncs_by_call(recs) -> list:
    """[{span name: syncs}, ...] per call of a tracing record, in call order."""
    out: dict = {}
    for r in recs:
        counted = out.setdefault(r.call, {})
        if r.syncs:
            counted[r.name] = counted.get(r.name, 0) + len(r.syncs)
    return [out[c] for c in sorted(out)]


def _host_ms(fn, x, calls: int) -> list:
    """Host ms inside each of ``calls`` calls of ``fn(x)``, with 2 calls
    queued on the card as in the benchmark's closed loop."""
    import collections

    import torch

    pending, host = collections.deque(), []
    for _ in range(calls):
        t = time.perf_counter()
        fn(x)
        host.append(1e3 * (time.perf_counter() - t))
        ev = torch.cuda.Event()
        ev.record()
        pending.append(ev)
        if len(pending) >= 2:
            pending.popleft().synchronize()
    torch.cuda.synchronize()
    return host


def tracing_phase(rng, card, device):
    """Phase 7g: the program's spans and syncs counter on the card, and the
    tracer's traced host cost."""
    import contextlib
    import statistics
    from unittest import mock

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark_torch.common.trace import read_profile
    from oclcomputervision_tpu_torch.models import EnhanceConfig, EnhancePipeline, RaisrModel
    from oclcomputervision_tpu_torch.utils import asset_path, tracing

    model = RaisrModel.load(asset_path("raisr_filters_x2.npz"), device=device)
    pipe = EnhancePipeline(EnhanceConfig(equalize="global", superres="raisr",
                                         resize_to=PIPE_RESIZE, resize_method="bicubic",
                                         pyramid_depth=PIPE_DEPTH), raisr_model=model)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    res = {}
    every = tracing.SAMPLE_EVERY
    for cell, fn in (("raisr_x2", model.upsample), ("enhance_720p", pipe)):
        x = torch.from_numpy(lenna_batch(rng, *CELL_SHAPES[cell])).to(device)

        def planted():
            with tracing.span("ocv.planted"):
                out = fn(x)
                (out[0] if isinstance(out, tuple) else out)[0, 0, 0].item()

        fn(x)
        torch.cuda.synchronize()
        tracing.reset()
        # two runs of SAMPLE_EVERY calls: only the first of each is sampled,
        # and the second run's first is the planted one
        with profile(activities=acts) as prof:
            with record_function("window"):
                host_start = time.perf_counter()
                for call in range(2 * every):
                    planted() if call == every else fn(x)
                torch.cuda.synchronize()
        got = _syncs_by_call(tracing.records())
        calls = sorted({r.call for r in tracing.records()})
        want = [CELL_SYNCS[cell], {**CELL_SYNCS[cell], "ocv.planted": 1}]
        leaked = sorted({n for n, _, _ in read_profile(prof, host_start).ops if "ocv." in n})
        print(f"tracing {cell}: sampled calls {calls}, syncs per call {got} (want {want}); "
              f"ocv. names among the device's operations: {leaked}")
        if calls != [0, every] or got != want or leaked:
            raise AssertionError(f"tracing {cell}: calls {calls}, syncs {got} != {want}, "
                                 f"or leaked {leaked}")

        # the tracer's traced host cost: with it and with the no-op, in turns,
        # each first on every other loop
        ways = {"tracer": contextlib.nullcontext,
                "no-op": lambda: mock.patch.object(tracing, "span", lambda name: tracing._OFF)}
        host = {(k, first): [] for k in ways for first in ways}
        tracing.reset()
        with profile(activities=acts):
            for loop in range(TRACE_LOOPS + 2):
                order = list(ways) if loop % 2 == 0 else list(ways)[::-1]
                for way in order:
                    with ways[way]():
                        ms = _host_ms(fn, x, TRACE_CALLS)
                    if loop > 1:  # the first two turns warm the profiled path up
                        host[way, order[0]] += ms
        tracing.reset()
        # the mean carries the sampled calls, one in SAMPLE_EVERY; the median
        # is a call that is not sampled
        both = {k: host[k, "tracer"] + host[k, "no-op"] for k in ways}
        med = {k: statistics.median(v) for k, v in both.items()}
        mean = {k: statistics.fmean(v) for k, v in both.items()}
        by_order = {first: statistics.fmean(host["tracer", first]) - statistics.fmean(host["no-op", first])
                    for first in ways}
        cost = mean["tracer"] - mean["no-op"]
        print(f"[{card}] tracing {cell}: host ms inside a call, traced, of "
              f"{TRACE_LOOPS} x {TRACE_CALLS} calls each way in turns: mean tracer "
              f"{mean['tracer']:.4f}, no-op {mean['no-op']:.4f}: the tracer's cost {cost:+.4f} ms "
              f"({by_order['tracer']:+.4f} in the loops it ran first, "
              f"{by_order['no-op']:+.4f} in those it ran second); median tracer "
              f"{med['tracer']:.4f}, no-op {med['no-op']:.4f}")
        res[cell] = {"syncs": got, "host_ms_mean": mean, "host_ms_median": med,
                     "tracer_cost_ms": cost, "tracer_cost_ms_by_first": by_order}
    return res


def compat_phase(rng, device):
    """Phase 7e: one call of each compat entry point on the card against its
    use_gpu=False / numpy oracle counterpart: histograms and motion equal,
    global histeq as phase 4b, local histeq, resize and pyramids within one
    level, RAISR above 40 dB."""
    import contextlib
    import io

    import numpy as np
    import torch

    from oclcomputervision_tpu_torch import compat
    from oclcomputervision_tpu_torch.kernels import _build
    from oclcomputervision_tpu_torch.models.raisr import RaisrModel
    from oclcomputervision_tpu_torch.oracle import histeq as o_histeq
    from oclcomputervision_tpu_torch.oracle import interpolation as o_interp
    from oclcomputervision_tpu_torch.oracle import motion as o_motion
    from oclcomputervision_tpu_torch.oracle import pyramid as o_pyramid
    from oclcomputervision_tpu_torch.oracle import raisr as o_raisr
    from oclcomputervision_tpu_torch.utils import asset_path, load_gray, load_image, psnr

    def maxdiff(a, b):
        a, b = np.asarray(a), np.asarray(b)
        if a.shape != b.shape:
            raise AssertionError(f"shapes {a.shape} and {b.shape}")
        return int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())

    def launched(tag, kernels, fn, *args, **kw):
        torch.cuda.synchronize()
        _build.reset_launches()
        with contextlib.redirect_stdout(io.StringIO()) as said:
            out = fn(*args, **kw)
        torch.cuda.synchronize()
        seen = {k: _build.LAUNCHES[k] for k in kernels}
        if min(seen.values(), default=1) < 1:
            raise AssertionError(f"compat {tag} launched {seen}")
        return out, said.getvalue().strip(), seen

    def check(tag, ok, what):
        print(f"compat {tag}: {what}")
        if not ok:
            raise AssertionError(f"compat {tag} disagrees: {what}")

    g = load_gray("lenna.png")
    res = {}
    out, said, seen = launched("histeq_global", GLOBAL_KERNELS, compat.histeq_global, g)
    d = np.abs(out.astype(int) - compat.histeq_global(g, use_gpu=False).astype(int))
    check("histeq_global", d.max() <= 1 and (d > 0).mean() < HISTEQ_ORACLE_SHARE,
          f"max {d.max()}, share off {(d > 0).mean():.7f} vs use_gpu=False; {seen}; {said!r}")
    out, said, seen = launched("histeq_local_block", LOCAL_KERNELS, compat.histeq_local_block, g)
    ref = g.copy()
    cpu = compat.histeq_local_block(ref, use_gpu=False)
    check("histeq_local_block", cpu is ref and maxdiff(out, cpu) <= 1,
          f"max {maxdiff(out, cpu)} vs use_gpu=False (which wrote its input in place); {seen}; {said!r}")

    eq = compat.HistEq.getInstance()
    (grid, ms), _, seen = launched("HistEq.histGrid", (), eq.histGrid, g)
    check("HistEq.histGrid", np.array_equal(grid, o_histeq.hist_grid(g, (32, 256))),
          f"equal to the oracle, {ms:.3f} ms")
    lut = rng.integers(0, 256, 256).astype(np.uint8)
    (out, ms), _, seen = launched("HistEq.histeqGlobal", ("apply_lut",), eq.histeqGlobal, g, lut)
    check("HistEq.histeqGlobal", np.array_equal(out, lut[g]), f"equal to lut[g], {seen}, {ms:.3f} ms")
    maps = rng.uniform(0, 255, (2, 2, 256)).astype(np.float32)
    (out, ms), _, seen = launched("HistEq.histeqLocalBlock", ("blend_blocks",), eq.histeqLocalBlock,
                                  g[:500, :460], maps, (256, 256))
    want = o_histeq.apply_block_mappings(g[:500, :460], maps, (256, 256))
    check("HistEq.histeqLocalBlock", maxdiff(out, want) <= 1,
          f"max {maxdiff(out, want)} vs the oracle, {seen}, {ms:.3f} ms")
    res["blend_tiles_launches"] = seen["blend_blocks"]

    rgb = load_image("lenna.png")
    util = compat.Utility()
    for name, method, mapping in (("bilinear", "bilinear", "hw_sampler"),
                                  ("bilinear_lds", "bilinear", "align_corners"),
                                  ("bicubic", "bicubic", "align_corners")):
        dst = np.zeros((700, 900, 3), np.uint8)
        (ms,), _, seen = launched(f"Utility.{name}", ("resize_sep",), getattr(util, name), rgb, dst)
        want = o_interp.resize_uint8(rgb, (700, 900), method, mapping)
        check(f"Utility.{name}", maxdiff(dst, want) <= 1,
              f"max {maxdiff(dst, want)} vs the oracle ({mapping}), {seen}, {ms:.3f} ms")

    r = compat.Raisr(0)
    src = g[128:384, 128:384]
    dst = np.zeros((512, 512), np.uint8)
    (ms,), _, seen = launched("Raisr.upsample", RAISR_KERNELS, r.upsample, src, dst, 2)
    bank = RaisrModel.load(asset_path("raisr_filters_x2.npz"), device="cpu")
    want = o_raisr.raisr_upsample(src, bank.filters.numpy().astype(np.float64), bank.cfg)
    check("Raisr.upsample", psnr(dst, want) > COMPAT_RAISR_PSNR,
          f"{psnr(dst, want):.4f} dB vs the numpy oracle (min {COMPAT_RAISR_PSNR}), {seen}")
    res["raisr_db"] = psnr(dst, want)

    f0, f1 = (load_gray(n)[200:320, 240:400] for n in ("frame10.png", "frame11.png"))
    mv, _, seen = launched("estimate_motion_vector", ("me_exact",), compat.estimate_motion_vector, f0, f1)
    check("estimate_motion_vector", np.array_equal(mv, o_motion.estimate_motion_vector(f0, f1, 15, 5)),
          f"{mv.shape} equal to the oracle, {seen}")
    seed = rng.uniform(-6, 6, mv.shape).astype(np.float32)
    mv, _, seen = launched("estimate_motion_vector seeded", ("me_exact",),
                           compat.estimate_motion_vector, f0, f1, seed=seed)
    check("estimate_motion_vector seeded",
          np.array_equal(mv, o_motion.estimate_motion_vector(f0, f1, 15, 5, seed=seed)),
          f"equal to the oracle, {seen}")
    levels, _, _ = launched("gaussian_pyramid", (), compat.gaussian_pyramid, g, 2, 3)
    want = o_pyramid.gaussian_pyramid(g, 2, 3)
    check("gaussian_pyramid", all(maxdiff(a, b) <= 1 for a, b in zip(levels, want)),
          f"{[lv.shape for lv in levels]} within one level of the oracle")
    up, _, _ = launched("upscale_mv", (), compat.upscale_mv, mv, 2)
    err = float(np.abs(up - o_motion.upscale_mv(mv, 2, "shipped")).max())
    check("upscale_mv", err <= 1e-4, f"{up.shape}, max |diff| {err:.3e} vs the oracle (max 1e-4)")
    return res


# ---------------------------------------------------------------------------
# Phase 7f: the image-domain and plane RAISR ops (ops/raisr.py's JAX names)
# ---------------------------------------------------------------------------

IMAGE_OPS_SHAPE = (2, 256, 256)  # LR images of lenna; x2 with the shipped bank


def image_ops_phase(rng, device):
    """Phase 7f: the eight image-domain and plane ops of ``ops.raisr``
    (the JAX package's public names) on CUDA tensors against the same calls
    on the CPU tensors, at 2 x 256^2 LR lenna images, x2 with the shipped
    bank: ``upscale_planes`` (through the upscale kernel) within
    UPSCALE_TOL, ``hash_planes`` (the hash kernel), ``hash_components`` and
    ``hash_image`` at >= HASH_AGREEMENT bucket agreement,
    ``pixel_type_map`` and ``ct_blend_weights`` equal, ``apply_filters`` and
    ``apply_filters_fast`` within APPLY_TOL; the interleaved ops launch no
    kernel."""
    import torch

    from oclcomputervision_tpu_torch.kernels import _build
    from oclcomputervision_tpu_torch.models.raisr import RaisrModel
    from oclcomputervision_tpu_torch.ops import raisr as R
    from oclcomputervision_tpu_torch.utils import asset_path

    model = RaisrModel.load(asset_path("raisr_filters_x2.npz"), device="cpu")
    cfg, bank = model.cfg, model.filters
    s = cfg.scale
    n, h, w = IMAGE_OPS_SHAPE
    x01 = R.true_div(torch.from_numpy(lenna_batch(rng, n, h, w)).float(), 255.0)
    geo = R.plane_geometry(h, w, cfg)
    pgeo = (geo.h2p, geo.w2p, geo.hq, geo.wq, geo.hp)

    def both(fn, *args):
        """(fn on the card's copies of args, fn on the CPU ones), on the CPU:
        tensors, or tuples of them."""
        card = fn(*(a.to(device) if isinstance(a, torch.Tensor) else a for a in args))
        card = tuple(t.cpu() for t in card) if isinstance(card, tuple) else card.cpu()
        return card, fn(*args)

    def agreement(a, b) -> float:
        return (a == b).double().mean().item()

    def max_diff(a, b) -> float:
        return (a - b).abs().max().item()

    torch.cuda.synchronize()
    _build.reset_launches()
    up_card, up_cpu = both(R.upscale_planes, x01, cfg, *pgeo)
    buckets = both(R.hash_planes, up_cpu, cfg, geo.hp, geo.h2p, geo.w2p)
    torch.cuda.synchronize()
    launched = {k: _build.LAUNCHES[k] for k in ("upscale_planes", "raisr_hash")}
    if min(launched.values()) < 1:
        raise AssertionError(f"phase 7f: the plane ops launched {launched}")
    res = {"upscale_planes_max_abs_err": max_diff(up_card, up_cpu),
           "hash_planes_agreement": agreement(*buckets), "launches": launched}

    interior = up_cpu[:, :, geo.hp : geo.hp + geo.h2p, geo.hp : geo.hp + geo.w2p]
    up = R.interleave_planes(interior, s, s * h, s * w)  # the cheap upscale [n, sh, sw]
    torch.cuda.synchronize()
    _build.reset_launches()
    ptype = (R.pixel_type_map(s * h, s * w, s, device=device).cpu(),
             R.pixel_type_map(s * h, s * w, s, device="cpu"))
    res["pixel_type_map_equal"] = torch.equal(*ptype) and ptype[1].dtype == torch.int32
    ct = both(R.ct_blend_weights, up)
    res["ct_blend_weights_equal"] = torch.equal(*ct)
    hi, hc, ap, apf = [], [], [], []
    for k in range(n):
        comps_card, comps = both(R.hash_components, up[k], cfg)
        hc += [agreement(a, b) for a, b in zip(comps_card, comps)]
        hash_img = both(R.hash_image, up[k], cfg)
        hi.append(agreement(*hash_img))
        fidx = hash_img[1] * cfg.num_pixel_type + ptype[1]
        ap.append(max_diff(*both(R.apply_filters, up[k], fidx, bank, cfg)))
        apf.append(max_diff(*both(R.apply_filters_fast, up[k], *comps, bank, cfg)))
    torch.cuda.synchronize()
    _no_launches("phase 7f interleaved ops")
    res.update(hash_components_agreement=min(hc), hash_image_agreement=min(hi),
               apply_filters_max_abs_err=max(ap), apply_filters_fast_max_abs_err=max(apf))
    print(f"phase 7f: ops.raisr image-domain and plane ops, card vs CPU, {n} x {h}x{w} LR x{s}: "
          f"upscale_planes max |diff| {res['upscale_planes_max_abs_err']:.3e} (max {UPSCALE_TOL}), "
          f"hash_planes {res['hash_planes_agreement']:.7f}, hash_components "
          f"{res['hash_components_agreement']:.7f}, hash_image {res['hash_image_agreement']:.7f} "
          f"bucket agreement (min {HASH_AGREEMENT}); pixel_type_map equal "
          f"{res['pixel_type_map_equal']}, ct_blend_weights equal {res['ct_blend_weights_equal']}; "
          f"apply_filters max |diff| {res['apply_filters_max_abs_err']:.3e}, apply_filters_fast "
          f"{res['apply_filters_fast_max_abs_err']:.3e} (max {APPLY_TOL}); launches {launched}, "
          f"none by the interleaved ops")
    if not (res["upscale_planes_max_abs_err"] <= UPSCALE_TOL
            and min(res["hash_planes_agreement"], res["hash_components_agreement"],
                    res["hash_image_agreement"]) >= HASH_AGREEMENT
            and res["pixel_type_map_equal"] and res["ct_blend_weights_equal"]
            and max(res["apply_filters_max_abs_err"],
                    res["apply_filters_fast_max_abs_err"]) <= APPLY_TOL):
        raise AssertionError(f"phase 7f: {res}")
    return res


# phase 8: the row-sharded and data-parallel paths (oclcomputervision_tpu_torch/parallel)
SHARD_RANKS = 4  # gloo ranks sharing the one card: NCCL takes one rank per card
SHARD_GLOBAL = (4320, 7680)  # one 8K frame
SHARD_LOCAL = (4096, 8192)  # 16 x 32 blocks of 256^2: 4 block rows a rank
SHARD_ME = (2160, 3840)  # one 4K pair: 540 rows a rank
SHARD_LR = 2048  # RAISR x2, 2048^2 -> 4096^2
SHARD_HALO = 8
SHARD_TRAIN_TOL = {"atol": 5e-3, "rtol": 1e-2}  # tests/test_parallel.py:130-132
SHARD_DB_TOL = 0.01  # frame11 x2 PSNR, the sharded bank against the single-device one
SHARD_REPS = 3  # timed calls after the first, whose launches are counted
SHARD_TIMEOUT_S = 420
# the kernels each sharded path must launch on every rank
SHARD_KERNELS = {
    "histeq_global": GLOBAL_KERNELS,
    "histeq_local_clahe0": LOCAL_KERNELS,
    "histeq_local_clahe2": LOCAL_KERNELS,
    "motion_fast": ("me_fast_round", "me_fast_median"),
    "motion_exact": ("me_exact",),
    "raisr": RAISR_KERNELS,
    "raisr_shipped": ("resize_sep",),  # the bilinear upscale alone
    # the train step's global arrays, which every rank makes of the corpus;
    # the step itself is torch.matmul per bucket piece and torch.linalg.solve
    "train_features": ("upscale_planes", "raisr_hash"),
    "train": (),
    "pipeline": GLOBAL_KERNELS + RAISR_KERNELS + ("resize_sep",),
}


def shard_inputs(seed: int) -> dict:
    """Phase 8's global arrays, the same in every process that makes them
    from ``seed``: an 8K and a 4096 x 8192 frame and a 2048^2 LR image of
    lenna tiles (``lenna_batch``), a 4K pair of frame10/11 tiles with +-4
    noise, and phase 7d's 16 x 768 x 1280 stack."""
    import numpy as np

    from oclcomputervision_tpu_torch.utils import load_gray

    rng = np.random.default_rng(seed + 8)
    h, w = SHARD_ME
    pair = []
    for name in ("frame10.png", "frame11.png"):
        f = load_gray(name)
        tile = np.tile(f, (-(-h // f.shape[0]), -(-w // f.shape[1])))[:h, :w]
        pair.append(np.clip(tile.astype(np.int16) + rng.integers(-4, 5, (h, w)), 0, 255)
                    .astype(np.uint8))
    return {"global": lenna_batch(rng, 1, *SHARD_GLOBAL)[0],
            "local": lenna_batch(rng, 1, *SHARD_LOCAL)[0],
            "f0": pair[0], "f1": pair[1],
            "lr": lenna_batch(rng, 1, SHARD_LR)[0],
            "pipe": lenna_batch(rng, *PIPE_SHAPE)}


def shard_train_arrays(device):
    """The train step's global arrays: phase 7c's corpus through the
    trainer's features (the upscale and hash kernels), concatenated, cut to
    an even count of pixels (the dp axis is 2)."""
    import numpy as np
    import torch

    from oclcomputervision_tpu_torch.models.raisr import _training_arrays, hr_luma01
    from oclcomputervision_tpu_torch.utils.config import RaisrConfig

    feats = [_training_arrays(torch.from_numpy(hr_luma01(im).astype(np.float32)).to(device),
                              RaisrConfig()) for im in train_corpus()]
    p, t, f = (torch.cat(z) for z in zip(*feats))
    n = p.shape[0] - p.shape[0] % 2
    return p[:n], t[:n], f[:n]


def _pipe_cfg():
    from oclcomputervision_tpu_torch.models import EnhanceConfig

    return EnhanceConfig(equalize="global", superres="raisr", resize_to=PIPE_RESIZE,
                         resize_method="bicubic", pyramid_depth=PIPE_DEPTH)


def shard_paths(x, train, model, mesh, mesh_dp_tp) -> dict:
    """Each sharded entry point on phase 8's inputs, as a call."""
    from oclcomputervision_tpu_torch import parallel
    from oclcomputervision_tpu_torch.models import EnhancePipeline

    nf, fl = model.cfg.num_filters, model.cfg.filter_len
    pipe = EnhancePipeline(_pipe_cfg(), raisr_model=model).sharded(mesh)
    return {
        "histeq_global": lambda: parallel.histeq_global_sharded(x["global"], mesh),
        "histeq_local_clahe0": lambda: parallel.histeq_local_sharded(
            x["local"], mesh, blockshape=BLOCK),
        "histeq_local_clahe2": lambda: parallel.histeq_local_sharded(
            x["local"], mesh, blockshape=BLOCK, clahe_clip=2.0),
        "motion_fast": lambda: parallel.motion_fast_sharded(x["f0"], x["f1"], mesh, "data",
                                                            *ME_GEOMETRY),
        "motion_exact": lambda: parallel.motion_exact_sharded(x["f0"], x["f1"], mesh, "data",
                                                              *ME_GEOMETRY),
        "raisr": lambda: parallel.raisr_upsample_sharded(x["lr"], model.filters, model.cfg, mesh,
                                                         halo=SHARD_HALO),
        "raisr_shipped": lambda: parallel.raisr_upsample_sharded(
            x["lr"], model.filters, _shipped(model.cfg), mesh, halo=SHARD_HALO),
        "train": lambda: parallel.raisr_train_step(*train, nf, fl, mesh_dp_tp),
        "pipeline": lambda: pipe(x["pipe"]),
    }


def _shipped(cfg):
    import dataclasses

    return dataclasses.replace(cfg, fidelity="shipped")


def shard_singles(x, train, model, device) -> dict:
    """The single-device op of each sharded path, on the same inputs."""
    from oclcomputervision_tpu_torch import ops
    from oclcomputervision_tpu_torch.models import EnhancePipeline, RaisrModel
    from oclcomputervision_tpu_torch.models.raisr import accumulate_normal_eq, solve_filters

    nf, fl = model.cfg.num_filters, model.cfg.filter_len
    pipe = EnhancePipeline(_pipe_cfg(), raisr_model=model)
    on = {"device": device}
    return {
        "histeq_global": lambda: ops.histeq_global(x["global"], **on),
        "histeq_local_clahe0": lambda: ops.histeq_local_block(x["local"], blockshape=BLOCK, **on),
        "histeq_local_clahe2": lambda: ops.histeq_local_block(x["local"], blockshape=BLOCK,
                                                              clahe_clip=2.0, **on),
        "motion_fast": lambda: ops.estimate_motion_vector(x["f0"], x["f1"], *ME_GEOMETRY,
                                                          method="fast", **on),
        "motion_exact": lambda: ops.estimate_motion_vector(x["f0"], x["f1"], *ME_GEOMETRY,
                                                           method="exact", **on),
        "raisr": lambda: model.upsample(x["lr"]),
        "raisr_shipped": lambda: RaisrModel(_shipped(model.cfg), model.filters).upsample(x["lr"]),
        # raisr_train_step's defaults: chunk 256, ridge 0.03
        "train": lambda: solve_filters(*accumulate_normal_eq(*train, nf, 256), fl),
        "pipeline": lambda: pipe(x["pipe"], **on),
    }


def _flat(out) -> list:
    """An output (a tensor, or a tuple or list of them, nested) as a list."""
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat(o)]
    return [out]


def sharded_rank(device, out_dir: str, seed: str) -> None:
    """Phase 8's rank body, run by parallel/launch.py on every rank: each
    sharded path once with the launch counts reset before it (rank 0 saves
    the gathered outputs), then SHARD_REPS timed calls between barriers.
    Writes rank<r>.json: the launches and the median wall ms of each path."""
    import statistics

    import numpy as np
    import torch
    import torch.distributed as dist

    from oclcomputervision_tpu_torch import parallel
    from oclcomputervision_tpu_torch.kernels import _build
    from oclcomputervision_tpu_torch.models import RaisrModel
    from oclcomputervision_tpu_torch.utils import asset_path

    rank, n = dist.get_rank(), dist.get_world_size()
    x = shard_inputs(int(seed))
    model = RaisrModel.load(asset_path("raisr_filters_x2.npz"), device=device)
    _build.reset_launches()
    train = shard_train_arrays(device)
    torch.cuda.synchronize()
    rec = {"launches": {"train_features": dict(_build.LAUNCHES)}, "ms": {}}
    dp = 2 if n % 2 == 0 else 1
    mesh = parallel.make_mesh(device=device)
    mesh_dp_tp = parallel.make_mesh((dp, n // dp), ("dp", "tp"), device=device)
    if dist.get_backend() == "nccl":
        def barrier():
            dist.barrier(device_ids=[device.index])
    else:
        barrier = dist.barrier
    for name, fn in shard_paths(x, train, model, mesh, mesh_dp_tp).items():
        torch.cuda.synchronize()
        barrier()
        _build.reset_launches()
        out = _flat(fn())
        torch.cuda.synchronize()
        rec["launches"][name] = dict(_build.LAUNCHES)
        if rank == 0:
            for k, o in enumerate(out):
                np.save(os.path.join(out_dir, f"{name}.{k}.npy"), o.cpu().numpy())
        del out
        times = []
        for _ in range(SHARD_REPS):
            barrier()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        rec["ms"][name] = statistics.median(times)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
        json.dump(rec, fh)


def _run_ranks(nproc: int, backend: str, out_dir: str, seed: int) -> float:
    """Run ``sharded_rank`` on ``nproc`` ranks on the card through
    ``parallel.launch.spawn`` (its session killed whole on a timeout); raises
    if any rank fails. Returns the seconds the run took, spawning included."""
    from oclcomputervision_tpu_torch.parallel.launch import spawn

    t0 = time.perf_counter()
    spawn(nproc, f"{os.path.abspath(__file__)}:sharded_rank", (out_dir, seed), backend, "cuda",
          timeout=SHARD_TIMEOUT_S)
    return time.perf_counter() - t0


def sharded_phase(seed: int, card, device):
    """Phase 8: each sharded path (``shard_paths``) on SHARD_RANKS gloo ranks
    sharing the card, then on one NCCL rank, held against the single-device
    op on the card: equal bit for bit, the train step's bank within
    SHARD_TRAIN_TOL and its frame11 x2 PSNR within SHARD_DB_TOL. Returns the
    per-path record and the ranks' launches summed per kernel and path."""
    import tempfile

    import numpy as np
    import torch

    from oclcomputervision_tpu_torch.models import RaisrModel
    from oclcomputervision_tpu_torch.utils import asset_path, load_gray, psnr

    x = shard_inputs(seed)
    model = RaisrModel.load(asset_path("raisr_filters_x2.npz"), device=device)
    train = shard_train_arrays(device)
    refs, single_ms = {}, {}
    for name, fn in shard_singles(x, train, model, device).items():
        refs[name] = [o.cpu().numpy() for o in _flat(fn())]
        single_ms[name] = wall_ms(fn, warmup=0, iters=SHARD_REPS)
    del train
    torch.cuda.empty_cache()
    hr11, lr11 = degrade(load_gray("frame11.png"), 2)

    def bank_db(bank):
        return psnr(RaisrModel(model.cfg, torch.from_numpy(bank).to(device)).upsample(lr11)
                    .cpu().numpy(), hr11)

    single_db = bank_db(refs["train"][0])
    runs = {}
    for tag, nproc, backend in (("gloo", SHARD_RANKS, "gloo"), ("nccl", 1, "nccl")):
        with tempfile.TemporaryDirectory() as out_dir:
            secs = _run_ranks(nproc, backend, out_dir, seed)
            recs = []
            for r in range(nproc):
                with open(os.path.join(out_dir, f"rank{r}.json")) as fh:
                    recs.append(json.load(fh))
            for name, need in SHARD_KERNELS.items():
                missing = [(r, k) for r, rec in enumerate(recs) for k in need
                           if rec["launches"][name][k] < 1]
                if missing:
                    raise AssertionError(f"phase 8 {tag} {name}: ranks launched no {missing}")
                if not need and any(any(rec["launches"][name].values()) for rec in recs):
                    raise AssertionError(f"phase 8 {tag} {name}: a path of torch ops launched "
                                         f"{[rec['launches'][name] for rec in recs]}")
                runs.setdefault(name, {})[tag] = {
                    "launches": {k: sum(rec["launches"][name][k] for rec in recs)
                                 for k in KERNELS}}
            for name, want in refs.items():
                got = [np.load(os.path.join(out_dir, f"{name}.{k}.npy")) for k in range(len(want))]
                if any(g.shape != w.shape for g, w in zip(got, want)):
                    raise AssertionError(f"phase 8 {tag} {name}: shapes {[g.shape for g in got]}")
                if name == "train":
                    err = float(np.abs(got[0] - want[0]).max())
                    db = bank_db(got[0])
                    ok = bool(np.allclose(got[0], want[0], **SHARD_TRAIN_TOL))
                    ok = ok and abs(db - single_db) <= SHARD_DB_TOL
                    what = (f"bank max |diff| {err:.3e} (allclose {SHARD_TRAIN_TOL}), frame11 x2 "
                            f"{db:.4f} dB vs {single_db:.4f} single-device (max off {SHARD_DB_TOL})")
                else:
                    ok = all(np.array_equal(g, w) for g, w in zip(got, want))
                    what = "equal to the single-device op bit for bit" if ok else "DIFFERS"
                runs[name][tag].update(ms=max(rec["ms"][name] for rec in recs), check=what)
                if not ok:
                    raise AssertionError(f"phase 8 {tag} {name}: {what}")
            print(f"phase 8: {nproc} {backend} rank(s) ran every path in {secs:.2f} s, spawning "
                  f"included")
    for name in refs:
        run = runs[name]
        print(f"[{card}] sharded {name}: {SHARD_RANKS} gloo ranks {run['gloo']['ms']:.4f} ms, "
              f"1 NCCL rank {run['nccl']['ms']:.4f} ms, the single-device op "
              f"{single_ms[name]:.4f} ms (wall, median of {SHARD_REPS}; the {SHARD_RANKS} ranks "
              f"share one card and stage their collectives through host memory, so this is the "
              f"cost of the collectives, not scaling); {run['gloo']['check']}; 1 rank: "
              f"{run['nccl']['check']}")
        run["single_ms"] = single_ms[name]
    return runs



# ---------------------------------------------------------------------------
# Phase 9: the example scripts (examples_torch/) on the card
# ---------------------------------------------------------------------------

EXAMPLES_TIMEOUT_S = 300  # per script run
ME_DEMO_DEFAULTS = dict(levels=3, search_size=15, patch_size=5, seed_mode="fixed", smooth=0,
                        subpixel=0, refine="auto")  # examples_torch/me_demo.py's
# (run name, script, its arguments; "{dir}" is the run's own temporary directory)
EXAMPLE_RUNS = (
    ("histeq_demo", "histeq_demo", ["--out", "{dir}/panel.png"]),
    ("histeq_demo --local", "histeq_demo", ["--local", "--out", "{dir}/panel.png"]),
    ("interpolation_bench", "interpolation_bench", []),
    ("me_demo", "me_demo", ["--outdir", "{dir}"]),
    ("me_demo --method fast", "me_demo", ["--method", "fast", "--outdir", "{dir}"]),
    ("raisr_bench", "raisr_bench", []),
    ("train_banks --scales 2", "train_banks", ["--scales", "2", "--bank-dir", "{dir}"]),
    ("video_pipeline", "video_pipeline", []),
)
_NUM = r"([0-9.]+|inf)"


def _found(pattern: str, out: str, run: str) -> list:
    """Every match of ``pattern`` in ``out`` as tuples of floats; raises
    where there is none."""
    import re

    hits = [tuple(float(v) for v in m) if isinstance(m, tuple) else (float(m),)
            for m in re.findall(pattern, out)]
    if not hits:
        raise AssertionError(f"phase 9 {run}: no line matches {pattern!r} in:\n{out[-3000:]}")
    return hits


def _example_numbers(run: str, out: str, d: str, device) -> dict:
    """The numbers a run printed, checked: the lines each script must print,
    and what phase 9 holds them to."""
    import numpy as np

    from oclcomputervision_tpu_torch.ops import estimate_motion_pyramid
    from oclcomputervision_tpu_torch.utils import load_gray, read_flo, read_png

    script = run.split()[0]
    if script == "histeq_demo":
        mode = "local" if "--local" in run else "global"
        (ms,), = _found(rf"ours \({mode}\) on .*: {_NUM} ms \(first call\)", out, run)
        panel = read_png(os.path.join(d, "panel.png"))
        if panel.ndim != 3 or panel.shape[2] != 3:
            raise AssertionError(f"phase 9 {run}: panel {panel.shape}")
        return {"first_call_ms": ms, "panel_shape": list(panel.shape)}
    if script == "interpolation_bench":
        rows = {}
        for method in ("bilinear", "bicubic"):
            (ms, mps, db), = _found(rf"{method}: cuda took {_NUM} ms \({_NUM} MP out/s\), PSNR "
                                    rf"vs oracle: {_NUM}", out, run)
            if not db > 50:  # tests/test_examples.py:75's bound
                raise AssertionError(f"phase 9 {run}: {method} PSNR vs oracle {db}")
            rows[method] = {"ms": ms, "mp_out_per_s": mps, "psnr_vs_oracle": db}
        return rows
    if script == "me_demo":
        method = "fast" if "fast" in run else "exact"
        epes = [e for (_lv, e) in _found(rf"layer ([0-9]+) [0-9]+x[0-9]+: EPE {_NUM}", out, run)]
        g0, g1 = load_gray("frame10.png"), load_gray("frame11.png")
        p = ME_DEMO_DEFAULTS
        flows = estimate_motion_pyramid(g0, g1, p["levels"], p["search_size"], p["patch_size"],
                                        p["seed_mode"], method, p["smooth"],
                                        subpixel=p["subpixel"], refine=p["refine"], device=device)
        for lv, f in enumerate(flows):
            if not np.array_equal(read_flo(os.path.join(d, f"layer{lv}.flo")), f.cpu().numpy()):
                raise AssertionError(f"phase 9 {run}: layer{lv}.flo differs from the direct call")
        (ms,), = _found(rf"pyramid flow on .*: {_NUM} ms", out, run)
        return {"first_call_ms": ms, "epe_by_level": epes, "flo_equal_to_direct_call": True}
    if script == "raisr_bench":
        rows = {}
        for what in ("single image", "batch-16"):
            (wall, wall_mps, dev_ms, dev_mps), = _found(
                rf"RAISR 2x {what}: {_NUM} ms/img wall = {_NUM} MP out/s; device {_NUM} ms/img = "
                rf"{_NUM} MP out/s", out, run)
            rows[what] = {"wall_ms_per_img": wall, "wall_mp_out_per_s": wall_mps,
                          "device_ms_per_img": dev_ms, "device_mp_out_per_s": dev_mps}
        (bil, bic, ra), = _found(rf"PSNR vs HR: bilinear {_NUM}  bicubic {_NUM}  raisr {_NUM}",
                                 out, run)
        if not ra > bic:
            raise AssertionError(f"phase 9 {run}: RAISR {ra} dB not above bicubic {bic}")
        return {**rows, "psnr": {"bilinear": bil, "bicubic": bic, "raisr": ra}}
    if script == "train_banks":
        (ra, bic, _gain), = _found(rf"x2: ridge=.* frame11 PSNR raisr {_NUM} bicubic {_NUM} "
                                   rf"\(\+?(-?[0-9.]+)\)", out, run)
        if not ra > bic:
            raise AssertionError(f"phase 9 {run}: frame11 x2 {ra} dB not above bicubic {bic}")
        if not os.path.isfile(os.path.join(d, "raisr_filters_x2.npz")):
            raise AssertionError(f"phase 9 {run}: no bank in --bank-dir")
        return {"frame11_x2_psnr": ra, "bicubic_psnr": bic,
                "val_psnr_by_ridge": [v for (_r, v) in _found(
                    rf"x2 ridge={_NUM}: val PSNR {_NUM}", out, run)]}
    if script == "video_pipeline":
        rows = {}
        for mode in ("sustained", "streaming"):
            (ms, fps, mps), = _found(
                rf"{mode} \(.*\): {_NUM} ms/frame = {_NUM} fps \({_NUM} MP/s\)", out, run)
            rows[mode] = {"ms_per_frame": ms, "fps": fps, "mp_per_s": mps}
        return rows
    raise AssertionError(f"phase 9: no check for {run}")


def examples_phase(card, device):
    """Phase 9: each examples_torch script once on the card, as a child
    process (EXAMPLE_RUNS): it must exit 0 and print its lines; me_demo's
    .flo files must equal a direct ``estimate_motion_pyramid`` call with the
    same arguments on the card, train_banks' frame11 x2 PSNR must beat
    bicubic. Returns each run's numbers and its seconds, and the versions
    of cv2 and PIL found (None: not installed)."""
    import importlib
    import tempfile

    res = {"optional_modules": {}}
    for name in ("cv2", "PIL"):  # the scripts take their cv2 / decoder paths where present
        try:
            mod = importlib.import_module(name)
            res["optional_modules"][name] = getattr(mod, "__version__", "?")
        except ImportError:
            res["optional_modules"][name] = None
    print(f"phase 9: optional modules in this Python: {res['optional_modules']} (None: not "
          f"installed)")
    for run, script, args in EXAMPLE_RUNS:
        with tempfile.TemporaryDirectory() as d:
            cmd = [sys.executable, os.path.join(ROOT, "examples_torch", f"{script}.py"),
                   *(a.replace("{dir}", d) for a in args)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                                  timeout=EXAMPLES_TIMEOUT_S)
            secs = time.perf_counter() - t0
            if proc.returncode != 0:
                raise AssertionError(f"phase 9 {run}: exit {proc.returncode}\n"
                                     f"{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
            res[run] = {**_example_numbers(run, proc.stdout, d, device), "seconds": secs}
        print(f"[{card}] phase 9 {run}: {secs:.2f} s, exit 0; printed:")
        for line in proc.stdout.strip().splitlines():
            print(f"    {line}")
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="input noise and rolls")
    args = ap.parse_args()

    import numpy as np
    import torch

    from oclcomputervision_tpu_torch import require_cuda
    from oclcomputervision_tpu_torch.kernels import _build
    from oclcomputervision_tpu_torch.models.raisr import RaisrModel
    from oclcomputervision_tpu_torch.utils import asset_path, load_image

    # phase 1: the card
    device = require_cuda()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")

    # phase 2: build
    t0 = time.perf_counter()
    nvcc_s = _build.build()
    _build.library()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s (nvcc {nvcc_s:.2f} s)")

    rng = np.random.default_rng(args.seed)
    model = RaisrModel.load(asset_path("raisr_filters_x2.npz"), device=device)

    # phase 3: kernels against their plain versions (x3 and x4 at a small size)
    errs = kernel_vs_plain(model, lenna_batch(rng, 2, LR), device)
    hash_agree = [errs["raisr_hash"]["agreement"], hash_contents(model, rng, device)]
    tiled = [tiling_cases(model, rng, device), band_cases(model, rng, device)]
    worst = []
    for scale in (3, 4):
        other = RaisrModel.load(asset_path(f"raisr_filters_x{scale}.npz"), device=device)
        small = kernel_vs_plain(other, lenna_batch(rng, 1, 256), device)
        hash_agree.append(small["raisr_hash"]["agreement"])
        worst.append({k: v["max_abs_err"] for k, v in small.items()})
        tiled.append(tiling_cases(other, rng, device))
    for name in ("upscale_planes", "raisr_apply"):  # the largest over every case
        errs[name]["max_abs_err"] = max(errs[name]["max_abs_err"],
                                        *(w[name] for w in worst + tiled))
    # the lowest bucket agreement over every case
    errs["raisr_hash"]["min_agreement"] = min(*hash_agree, *(t["raisr_hash"] for t in tiled))

    # phase 3d: the generic RAISR forms against their plain versions
    generic = generic_models(rng, device)
    errs.update(generic_vs_plain(generic, rng, device))

    # phase 3b: the histeq kernels against their plain versions
    batches = histeq_batches(rng, device)
    errs.update(histeq_kernel_vs_plain(batches, rng, device))

    # phase 3c: the motion kernels against their plain versions
    errs.update(me_kernel_vs_plain(rng, device))

    # phase 4: RAISR end to end
    batch = lenna_batch(rng, BATCH, LR)
    out, launches = main_path(model, batch, load_image("lenna.png"), rng, device)

    # phase 4d: a model per generic config end to end
    launches.update(generic_main_path(generic, rng, device))

    # phase 4b: histeq end to end
    launches.update(histeq_main_path(batches, rng, device))

    # phases 4c and 5c: motion estimation end to end, and its quality
    me_launches, me_epe, pyramid_batch = me_main_path(rng, device)
    launches.update(me_launches)

    # phase 5: quality
    quality(model)

    # phase 6: RAISR timing
    times, e2e = timing(model, batch, out, card, device)
    del out

    # phase 6d: the generic forms' timing
    times.update(generic_timing(generic, rng, card, device))

    # phase 6e: each generic config end to end at the bench geometry
    e2e_generic = generic_bench(generic, rng, e2e["mp_out_per_s"], card, device)
    del generic
    # its checks at the bench geometry join phase 3d's in the kernels line
    for r in e2e_generic.values():
        if "raisr_hash_generic" in r["stages"]:  # else the compiled hash (filter_len 13)
            hg = errs["raisr_hash_generic"]
            hg["agreement"] = min(hg["agreement"], r["hash_agreement"])
        else:
            hg = errs["raisr_hash"]
            hg["min_agreement"] = min(hg["min_agreement"], r["hash_agreement"])
        hg["differing"] += r["hash_differing"]
        ap = errs["raisr_apply_split" if "raisr_apply_split" in r["stages"]
                  else "raisr_apply_generic"]
        ap["max_abs_err"] = max(ap["max_abs_err"], r["apply_max_abs_err"])

    # phase 6b: histeq timing
    histeq_times, histeq_e2e = histeq_timing(batches, card, device)
    times.update(histeq_times)
    del batches

    # phase 6c: motion timing
    me_times, me_e2e = me_timing(rng, pyramid_batch, card, device)
    times.update(me_times)
    e2e = {"raisr_x2": e2e, "raisr_generic": e2e_generic, **histeq_e2e, **me_e2e,
           "me_epe": me_epe}

    # phases 7-7e and 7g: resize, RAISR 'shipped', the trainer, EnhancePipeline,
    # the program's spans, compat
    (e2e["resize"], errs["resize_sep"], times["resize_sep"],
     launches["resize_sep"]) = resize_phase(rng, card, device)
    e2e["raisr_shipped"] = shipped_phase(device)
    e2e["raisr_train"] = trainer_phase(card, device)
    e2e["enhance_pipeline"] = pipeline_phase(rng, card, device)
    e2e["tracing"] = tracing_phase(rng, card, device)
    e2e["compat"] = compat_phase(rng, device)

    # phase 7f: ops.raisr's image-domain and plane ops, card against CPU
    e2e["raisr_image_ops"] = image_ops_phase(rng, device)

    # phase 8: the sharded paths on torch.distributed, on 4 gloo ranks and 1 NCCL rank;
    # the ranks' launches stand beside the main paths' in the kernels line
    e2e["sharded"] = sharded_phase(args.seed, card, device)
    # per kernel, each sharded path that launched it: the launches of its
    # SHARD_RANKS gloo ranks together and of its one NCCL rank, apart
    sharded = {k: {path: {b: r[b]["launches"][k] for b in ("gloo", "nccl")}
                   for path, r in e2e["sharded"].items()
                   if r["gloo"]["launches"][k] or r["nccl"]["launches"][k]}
               for k in KERNELS}

    # phase 9: the example scripts, each once on the card as a child process
    e2e["examples"] = examples_phase(card, device)

    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": src,
            "replaces": replaces,
            "launches": launches[name],
            "sharded_launches": sharded[name],
            **errs[name],
            **times[name],
        }
        for name, (src, replaces) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels, "e2e": e2e, "card": card}))
    if "jax" in sys.modules or "oclcomputervision_tpu" in sys.modules:
        raise AssertionError("jax or the JAX package was imported")
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
