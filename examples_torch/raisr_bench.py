"""RAISR benchmark on the PyTorch port (``examples/raisr_bench.py``'s twin;
super_resolution/raisr.py __main__ equivalent).

Loads the shipped x2 filter bank (``assets/raisr_filters_x2.npz``) through
``RaisrModel.load``, or trains one with ``RaisrModel.train`` (--train),
degrades a held-out image 2x, restores it with bilinear, bicubic and RAISR,
and reports the PSNR of each, and the RAISR rate for one image and for a
batch of --batch: the wall of a call that ends in a synchronise
(``bench_op``) and, on the card, its device time (``cuda_time_ms``).
A trained bank goes to --bank-dir, never into ``assets/``, which the
tests read. Training takes lenna, frame10 and under_exposure.jpg; without
a JPEG decoder (cv2 or PIL) the last is left out, and the script says so.

  python examples_torch/raisr_bench.py [--image frame11.png] [--train]
"""

import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

import numpy as np  # noqa: E402

import _common  # noqa: E402


def main():
    import torch

    from oclcomputervision_tpu_torch._device import as_tensor
    from oclcomputervision_tpu_torch.models.raisr import RaisrModel
    from oclcomputervision_tpu_torch.ops.interpolation import resize_uint8
    from oclcomputervision_tpu_torch.utils import asset_path, load_gray, load_image, psnr
    from oclcomputervision_tpu_torch.utils.config import RaisrConfig
    from oclcomputervision_tpu_torch.utils.profiling import bench_op, cuda_time_ms, timed

    ap = argparse.ArgumentParser()
    ap.add_argument("--image", default="frame11.png", help="held-out eval asset")
    ap.add_argument("--train", action="store_true", help="retrain instead of loading")
    ap.add_argument("--loop", type=int, default=20)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--bank-dir", default=os.path.join(_common.REPO, "out", "banks_torch"),
                    help="where --train saves its bank (never assets/)")
    _common.add_device_flag(ap)
    args = ap.parse_args()
    dev = _common.device_of(args)
    label = _common.device_label(dev)

    if args.train:
        cfg = RaisrConfig(fidelity="full")
        imgs = [load_image("lenna.png"), load_image("frame10.png")]
        ue = _common.read_rgb(asset_path("under_exposure.jpg"))
        if ue is None:
            print("no JPEG decoder (neither cv2 nor PIL is installed): training on lenna and "
                  "frame10 without under_exposure.jpg")
        else:
            imgs.append(ue)
        model, ms = timed(lambda: RaisrModel(cfg=cfg).train(imgs, device=dev))
        print(f"trained filter bank in {ms:.0f} ms on {label}")
        os.makedirs(args.bank_dir, exist_ok=True)
        path = os.path.join(args.bank_dir, "raisr_filters_x2.npz")
        model.save(path)
        print(f"saved the bank to {path}")
    else:
        model = RaisrModel.load(asset_path("raisr_filters_x2.npz"), device=dev)

    hr = load_gray(args.image)
    h, w = (hr.shape[0] // 2) * 2, (hr.shape[1] // 2) * 2
    hr = hr[:h, :w]
    lr = hr.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3)).round().astype(np.uint8)

    bil = resize_uint8(lr, (h, w), "bilinear", device=dev).cpu().numpy()
    bic = resize_uint8(lr, (h, w), "bicubic", device=dev).cpu().numpy()
    ra, ms = timed(model.upsample, lr)
    ra = ra.cpu().numpy()
    print(f"first RAISR call on {label}: {ms:.1f} ms")

    mp_out = h * w / 1e6
    on_card = dev.type == "cuda"

    def rate(what, x, n, iters):
        ms = bench_op(model.upsample, x, iters=iters)
        line = (f"RAISR 2x {what}: {ms / n:.3f} ms/img wall = {n * mp_out / ms * 1000:.0f} "
                f"MP out/s")
        if on_card:
            dms = cuda_time_ms(model.upsample, x, iters=iters)
            line += f"; device {dms / n:.3f} ms/img = {n * mp_out / dms * 1000:.0f} MP out/s"
        print(line)

    x = as_tensor(lr, dev)
    rate("single image", x, 1, args.loop)
    rate(f"batch-{args.batch}", torch.stack([x] * args.batch), args.batch,
         max(3, args.loop // 4))
    print(
        "PSNR vs HR: bilinear {:.3f}  bicubic {:.3f}  raisr {:.3f}".format(
            psnr(bil, hr), psnr(bic, hr), psnr(ra, hr)
        )
    )


if __name__ == "__main__":
    main()
