"""Headless histogram-equalization demo on the PyTorch port
(``examples/histeq_demo.py``'s twin; histeq_test.py equivalent).

Equalizes the Y channel of a still (or every frame of a video, with --video
and cv2) through ``oclcomputervision_tpu_torch.ops`` on the card, and writes
a side-by-side panel with per-channel histogram strips: original | ours, and
OpenCV CLAHE (the reference's baseline, histeq_test.py:61,128) where cv2 is
installed. Without cv2 the BGR <-> YCrCb conversion is numpy with cv2's
BT.601 coefficients; without a JPEG decoder (cv2 or PIL) the default image,
under_exposure.jpg, is replaced by lenna.png, and the script says so.

  python examples_torch/histeq_demo.py --alpha 1.0 --punch 0.05 --clip 2.0
  python examples_torch/histeq_demo.py --local --device cpu
"""

import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

import numpy as np  # noqa: E402

import _common  # noqa: E402

# cv2's BT.601 YCrCb for 8-bit images (cv2.cvtColor, COLOR_BGR2YCrCb)
_YW = (0.299, 0.587, 0.114)  # R, G, B
_CR, _CB = 0.713, 0.564
_INV = (1.403, -0.714, -0.344, 1.773)  # R from Cr, G from Cr, G from Cb, B from Cb


def _u8(x) -> np.ndarray:
    return np.clip(np.round(x), 0, 255).astype(np.uint8)


def bgr2ycrcb(bgr: np.ndarray, cv2=None) -> np.ndarray:
    if cv2 is not None:
        return cv2.cvtColor(bgr, cv2.COLOR_BGR2YCrCb)
    b, g, r = (bgr[..., k].astype(np.float64) for k in range(3))
    y = _YW[0] * r + _YW[1] * g + _YW[2] * b
    return np.stack([_u8(y), _u8((r - y) * _CR + 128), _u8((b - y) * _CB + 128)], axis=-1)


def ycrcb2bgr(ycrcb: np.ndarray, cv2=None) -> np.ndarray:
    if cv2 is not None:
        return cv2.cvtColor(ycrcb, cv2.COLOR_YCrCb2BGR)
    y, cr, cb = (ycrcb[..., k].astype(np.float64) for k in range(3))
    cr, cb = cr - 128, cb - 128
    r = y + _INV[0] * cr
    g = y + _INV[1] * cr + _INV[2] * cb
    b = y + _INV[3] * cb
    return np.stack([_u8(b), _u8(g), _u8(r)], axis=-1)


def equalize_bgr(bgr, alpha, punch, clip, local, device, cv2=None):
    from oclcomputervision_tpu_torch import ops

    ycrcb = bgr2ycrcb(bgr, cv2)
    y = ycrcb[:, :, 0]
    if local:
        h, w = y.shape
        bs = (min(256, h // 2), min(256, w // 2))
        y2 = np.ascontiguousarray(y[: h - h % bs[0], : w - w % bs[1]])
        eq = ops.histeq_local_block(y2, alpha, punch, clip, bs, device=device).cpu().numpy()
        y = y.copy()
        y[: eq.shape[0], : eq.shape[1]] = eq
    else:
        y = ops.histeq_global(np.ascontiguousarray(y), alpha, punch, clip,
                              device=device).cpu().numpy()
    ycrcb = ycrcb.copy()
    ycrcb[:, :, 0] = y
    return ycrcb2bgr(ycrcb, cv2)


def _polyline(strip: np.ndarray, xs: np.ndarray, ys: np.ndarray, color) -> None:
    """Draw the segments between consecutive points (x, y), 1 pixel wide."""
    for x0, y0, x1, y1 in zip(xs[:-1], ys[:-1], xs[1:], ys[1:]):
        n = int(max(abs(x1 - x0), abs(y1 - y0))) + 1
        strip[np.linspace(y0, y1, n).round().astype(int),
              np.linspace(x0, x1, n).round().astype(int)] = color


def plot_hist(bgr, device, height=120):
    """Per-channel histogram strip (histeq_test.py:63-99 equivalent): each
    channel's histogram from the port's ``histogram256``, drawn as B/G/R
    curves on a black strip as wide as the image."""
    from oclcomputervision_tpu_torch.ops import histogram256

    w = bgr.shape[1]
    strip = np.zeros((height, w, 3), np.uint8)
    for c, color in enumerate(((255, 0, 0), (0, 255, 0), (0, 0, 255))):
        chan = np.ascontiguousarray(bgr[:, :, c]).reshape(-1)
        hist = histogram256(chan, device=device).cpu().numpy().astype(np.float64)
        hist = hist / max(hist.max(), 1) * (height - 2)
        xs = np.linspace(0, w - 1, 256).astype(int)
        _polyline(strip, xs, height - 1 - hist.astype(int), color)
    return strip


def main():
    from oclcomputervision_tpu_torch.utils import asset_path, write_png
    from oclcomputervision_tpu_torch.utils.profiling import timed

    ap = argparse.ArgumentParser()
    ap.add_argument("--image", default=asset_path("under_exposure.jpg"))
    ap.add_argument("--video", default=None, help="optional video path (needs cv2)")
    ap.add_argument("--alpha", type=float, default=1.0)
    ap.add_argument("--punch", type=float, default=0.05)
    ap.add_argument("--clip", type=float, default=2.0)
    ap.add_argument("--local", action="store_true", help="local-block (CLAHE-style)")
    ap.add_argument("--out", default=os.path.join(_common.OUT_DIR, "histeq_demo.png"))
    _common.add_device_flag(ap)
    args = ap.parse_args()
    dev = _common.device_of(args)
    cv2 = _common.optional("cv2")
    mode = "local" if args.local else "global"
    eq_args = (args.alpha, args.punch, args.clip, args.local, dev, cv2)

    if args.video:
        if cv2 is None:
            sys.exit("--video needs cv2, which is not installed")
        cap = cv2.VideoCapture(args.video)
        n = 0
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            out, ms = timed(equalize_bgr, cv2.resize(frame, (1280, 768)), *eq_args)
            n += 1
            print(f"frame {n}: {ms:.2f} ms")
        return

    rgb = _common.read_rgb(args.image)
    if rgb is None:
        print(f"no decoder for {os.path.basename(args.image)} (neither cv2 nor PIL is "
              f"installed): equalizing lenna.png instead")
        rgb = _common.read_rgb(asset_path("lenna.png"))
    bgr = np.ascontiguousarray(rgb[..., ::-1])
    if cv2 is None:
        print("cv2 is not installed: BGR <-> YCrCb in numpy (cv2's BT.601 coefficients), "
              "no cv2 CLAHE panel")
    ours, ms = timed(equalize_bgr, bgr, *eq_args)
    print(f"ours ({mode}) on {_common.device_label(dev)}: {ms:.2f} ms (first call)")

    panels = [bgr, ours]
    if cv2 is not None:
        # OpenCV CLAHE baseline, reference settings (histeq_test.py:61)
        clahe = cv2.createCLAHE(clipLimit=2, tileGridSize=(3, 5))
        ycrcb = cv2.cvtColor(bgr, cv2.COLOR_BGR2YCrCb)
        ycrcb[:, :, 0] = clahe.apply(ycrcb[:, :, 0])
        panels.append(cv2.cvtColor(ycrcb, cv2.COLOR_YCrCb2BGR))
    panel = np.vstack([np.hstack(panels), np.hstack([plot_hist(p, dev) for p in panels])])
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    write_png(args.out, np.ascontiguousarray(panel[..., ::-1]))
    names = "original | ours" + (" | cv2-CLAHE" if cv2 is not None else "")
    print(f"wrote {args.out} ({names}, with histograms)")


if __name__ == "__main__":
    main()
