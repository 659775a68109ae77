"""Train RAISR filter banks under a held-out protocol on the PyTorch port
(``examples/train_banks.py``'s twin).

  TRAIN   lenna, frame10, the left 60% of under_exposure, plus one
          pyr_down level of each one's luma.
  VAL     the right 40% of under_exposure (never trained on): the per-scale
          ridge is grid-searched on VAL PSNR only.
  REPORT  frame11, untouched by training and tuning.

Without a JPEG decoder (neither cv2 nor PIL installed) the corpus is the
PNG part, split the same way: lenna's left 60% and frame10, a pyr_down of
each one's luma, and VAL lenna's right 40%. The script says which corpus it
used.

The G/r accumulation (``models.raisr._training_arrays``,
``accumulate_normal_eq``) runs once per scale; each ridge of the grid is one
``solve_filters``. The JAX script overwrites ``assets/raisr_filters_x{s}.npz``;
this one writes to --bank-dir and never touches ``assets/``, which the tests
read. --report-only reports the shipped banks in ``assets/``.

  python examples_torch/train_banks.py [--scales 2 3 4] [--report-only]
"""

import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

import numpy as np  # noqa: E402

import _common  # noqa: E402

RIDGE_GRID = (0.002, 0.004, 0.006, 0.01, 0.015, 0.03)
TRAIN_SHARE = 0.6  # of the split image's columns


def corpus():
    """(train images, VAL luma, a line naming the corpus)."""
    from oclcomputervision_tpu_torch.oracle.pyramid import pyr_down
    from oclcomputervision_tpu_torch.utils import asset_path, gray, load_gray, load_image

    ue = _common.read_rgb(asset_path("under_exposure.jpg"))
    if ue is not None:
        split = int(ue.shape[1] * TRAIN_SHARE)
        ue_gray = gray(ue)
        train = [load_image("lenna.png"), load_image("frame10.png"), ue[:, :split]]
        train += [pyr_down(load_gray(n)) for n in ("lenna.png", "frame10.png")]
        train += [pyr_down(np.ascontiguousarray(ue_gray[:, :split]))]
        return train, ue_gray[:, split:], "lenna, frame10, under_exposure (VAL its right 40%)"
    lenna = load_image("lenna.png")
    split = int(lenna.shape[1] * TRAIN_SHARE)
    lenna_gray = load_gray("lenna.png")
    train = [lenna[:, :split], load_image("frame10.png"),
             pyr_down(np.ascontiguousarray(lenna_gray[:, :split])),
             pyr_down(load_gray("frame10.png"))]
    return train, lenna_gray[:, split:], (
        "the PNG corpus (no JPEG decoder: under_exposure.jpg left out): lenna's left 60%, "
        "frame10 (VAL lenna's right 40%)")


def degrade(hr, s):
    h, w = (hr.shape[0] // s) * s, (hr.shape[1] // s) * s
    hr = hr[:h, :w]
    lr = hr.reshape(h // s, s, w // s, s).mean(axis=(1, 3)).round().astype(np.uint8)
    return hr, lr


def quality(model, hr_img):
    """(RAISR PSNR, bicubic PSNR) of the s x s box-mean LR of ``hr_img``,
    on the model's device."""
    from oclcomputervision_tpu_torch.ops.interpolation import resize_uint8
    from oclcomputervision_tpu_torch.utils import psnr

    s = model.cfg.scale
    hr, lr = degrade(hr_img, s)
    ra = model.upsample(lr).cpu().numpy()
    bic = resize_uint8(lr, hr.shape, "bicubic", device=model.filters.device).cpu().numpy()
    return psnr(ra, hr), psnr(bic, hr)


def main():
    import torch

    from oclcomputervision_tpu_torch.models.raisr import (
        RaisrModel,
        _training_arrays,
        accumulate_normal_eq,
        hr_luma01,
        solve_filters,
    )
    from oclcomputervision_tpu_torch.utils import asset_path, load_gray
    from oclcomputervision_tpu_torch.utils.config import RaisrConfig

    ap = argparse.ArgumentParser()
    ap.add_argument("--scales", type=int, nargs="+", default=[2, 3, 4])
    ap.add_argument(
        "--report-only", action="store_true",
        help="skip training; report frame11 PSNR of the shipped banks",
    )
    ap.add_argument("--bank-dir", default=os.path.join(_common.REPO, "out", "banks_torch"),
                    help="where the trained banks go (never assets/)")
    _common.add_device_flag(ap)
    args = ap.parse_args()
    dev = _common.device_of(args)

    report = load_gray("frame11.png")
    if not args.report_only:
        train, val, what = corpus()
        print(f"corpus: {what}; on {_common.device_label(dev)}")
    for s in args.scales:
        if args.report_only:
            m = RaisrModel.load(asset_path(f"raisr_filters_x{s}.npz"), device=dev)
            p_r, p_b = quality(m, report)
            print(f"x{s}: frame11 PSNR raisr {p_r:.2f} bicubic {p_b:.2f} (+{p_r - p_b:.2f})")
            continue
        cfg = RaisrConfig(scale=s, fidelity="full")
        # the G/r accumulators are ridge-independent: accumulate once, solve
        # per grid point
        d = cfg.filter_len**2
        g = torch.zeros((cfg.num_filters, d, d), dtype=torch.float32, device=dev)
        r = torch.zeros((cfg.num_filters, d), dtype=torch.float32, device=dev)
        cnt = torch.zeros((cfg.num_filters,), dtype=torch.float32, device=dev)
        for img in train:
            y01 = torch.from_numpy(hr_luma01(img).astype(np.float32)).to(dev)
            dg, dr, dc = accumulate_normal_eq(*_training_arrays(y01, cfg), cfg.num_filters)
            g, r, cnt = g + dg, r + dr, cnt + dc
        best = (None, -1.0, None)
        for ridge in RIDGE_GRID:
            f = solve_filters(g, r, cnt, cfg.filter_len, ridge)
            p_val, _ = quality(RaisrModel(cfg, f), val)
            print(f"x{s} ridge={ridge}: val PSNR {p_val:.3f}")
            if p_val > best[1]:
                best = (ridge, p_val, f)
        ridge, p_val, f = best
        m = RaisrModel(cfg, f)
        os.makedirs(args.bank_dir, exist_ok=True)
        path = os.path.join(args.bank_dir, f"raisr_filters_x{s}.npz")
        m.save(path)
        p_r, p_b = quality(m, report)
        print(
            f"x{s}: ridge={ridge} (val {p_val:.2f}) -> {path}; frame11 PSNR "
            f"raisr {p_r:.2f} bicubic {p_b:.2f} (+{p_r - p_b:.2f})"
        )


if __name__ == "__main__":
    main()
