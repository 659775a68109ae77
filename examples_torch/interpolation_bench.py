"""Interpolation benchmark on the PyTorch port (``examples/interpolation_bench.py``'s
twin; basic/interpolation.py __main__ equivalent).

Upscales lenna --size^2 -> (2 --size)^2 (the reference protocol at the
default 1024, basic/interpolation.py:121-124) with ``ops.resize_uint8`` on
the card, times it with ``bench_op`` over --loop calls (median wall of a
call that ends in a synchronise) and reports PSNR against the port's numpy
align-corners oracle (``oracle.interpolation.resize_uint8``). cv2's rows
appear where cv2 is installed; without cv2 the --size^2 source is the
port's own bicubic resize of lenna, and the script says so.

  python examples_torch/interpolation_bench.py [--size 1024 --loop 20]
"""

import argparse
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

import _common  # noqa: E402


def main():
    from oclcomputervision_tpu_torch._device import as_tensor
    from oclcomputervision_tpu_torch.ops.interpolation import resize_uint8
    from oclcomputervision_tpu_torch.oracle.interpolation import resize_uint8 as oracle_resize
    from oclcomputervision_tpu_torch.utils import load_image, psnr
    from oclcomputervision_tpu_torch.utils.profiling import bench_op

    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=1024, help="source side; output is twice it")
    ap.add_argument("--loop", type=int, default=20, help="timed calls per method")
    _common.add_device_flag(ap)
    args = ap.parse_args()
    dev = _common.device_of(args)
    cv2 = _common.optional("cv2")

    rgb = load_image("lenna.png")
    n = args.size
    if cv2 is not None:
        src = cv2.resize(rgb, (n, n))
    else:
        src = resize_uint8(rgb, (n, n), "bicubic", device=dev).cpu().numpy()
        print(f"cv2 is not installed: the {n}^2 source is the port's bicubic resize of "
              f"lenna, and there are no cv2 rows")
    hn = wn = 2 * n
    print(f"lenna {n}x{n} -> {wn}x{hn} on {_common.device_label(dev)}")
    x = as_tensor(src, dev)

    for method, mode in (("bilinear", "INTER_LINEAR"), ("bicubic", "INTER_CUBIC")):
        truth = oracle_resize(src, (hn, wn), method)
        if cv2 is not None:
            flag = getattr(cv2, mode)
            ms = bench_op(lambda: cv2.resize(src, (wn, hn), interpolation=flag), iters=args.loop)
            out_cv = cv2.resize(src, (wn, hn), interpolation=flag)
            print(f"{method}: cv2 took {ms:.3f} ms, PSNR vs oracle: {psnr(out_cv, truth):.3f}")

        out = resize_uint8(x, (hn, wn), method).cpu().numpy()
        ms = bench_op(lambda: resize_uint8(x, (hn, wn), method), iters=args.loop)
        mps = hn * wn / 1e6 / ms * 1000.0
        print(f"{method}: {dev.type} took {ms:.3f} ms ({mps:.0f} MP out/s), "
              f"PSNR vs oracle: {psnr(out, truth):.3f}")


if __name__ == "__main__":
    main()
