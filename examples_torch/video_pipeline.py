"""Serving-style video pipeline on the PyTorch port (``examples/video_pipeline.py``'s
twin): global histogram equalization of every frame plus fast dense motion
between consecutive frames, on frames resident on the card.

The frames are a synthetic panning scene: seeded uniform noise from a
``torch.Generator`` (seed 0) on the run's device, smoothed by a 16x16 box
filter, one (2, 3)-pixel step a frame; its values differ from the JAX
script's ``jax.random`` scene. With --video (needs cv2) they are a real
video's. Two rates:

- sustained: the whole chain of frames timed as one region between two
  CUDA events after a warm-up frame (the host clock on the CPU);
- streaming: the host wall per frame of the same chain, launched frame by
  frame with one synchronise at the end.

  python examples_torch/video_pipeline.py [--frames 64] [--width 1280 --height 768]
"""

import argparse
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

import _common  # noqa: E402

MARGIN = 256  # scene rows and columns beyond one frame: the pan's reach
BOX = 16


def synthetic_frames(n: int, h: int, w: int, device):
    """n uint8 [h, w] frames panning over one smooth seeded scene."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device=device).manual_seed(0)
    base = torch.rand((1, 1, h + MARGIN, w + MARGIN), generator=gen, device=device)
    # 'SAME' box filter of even size: (BOX - 1) // 2 zeros before, BOX // 2 after
    lo, hi = (BOX - 1) // 2, BOX // 2
    base = F.conv2d(F.pad(base, (lo, hi, lo, hi)),
                    torch.full((1, 1, BOX, BOX), 1.0 / (BOX * BOX), device=device))[0, 0]
    base = (base * 255).to(torch.uint8)
    return [base[min(2 * i, MARGIN) : min(2 * i, MARGIN) + h,
                 min(3 * i, MARGIN) : min(3 * i, MARGIN) + w].contiguous() for i in range(n)]


def main():
    import torch

    from oclcomputervision_tpu_torch._device import as_tensor
    from oclcomputervision_tpu_torch.ops import estimate_motion_vector, histeq_global

    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=768)
    ap.add_argument("--video", default=None, help="optional real video path (needs cv2)")
    _common.add_device_flag(ap)
    args = ap.parse_args()
    dev = _common.device_of(args)
    h, w = args.height, args.width

    if args.video:
        cv2 = _common.optional("cv2")
        if cv2 is None:
            sys.exit("--video needs cv2, which is not installed")
        cap = cv2.VideoCapture(args.video)
        frames = []
        while len(frames) < args.frames:
            ok, f = cap.read()
            if not ok:
                break
            frames.append(as_tensor(cv2.cvtColor(cv2.resize(f, (w, h)), cv2.COLOR_BGR2GRAY),
                                    dev))
    else:
        frames = synthetic_frames(args.frames, h, w, dev)
        print("synthetic panning frames from torch.Generator (seed 0): values differ from "
              "the JAX script's jax.random scene")
    n = len(frames)
    if n < 2:
        sys.exit(f"need at least 2 frames, got {n}")
    on_card = dev.type == "cuda"
    print(f"{n} frames of {w}x{h} on {_common.device_label(dev)}")

    def per_frame(prev, cur, acc):
        eq = histeq_global(cur)
        mv = estimate_motion_vector(prev, cur, 15, 5, method="fast")
        return acc + eq.sum(dtype=torch.float32) + mv.sum()

    def chain():
        acc = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(1, n):
            acc = per_frame(frames[i - 1], frames[i], acc)
        return acc

    zero = torch.zeros((), dtype=torch.float32, device=dev)
    float(per_frame(frames[0], frames[1], zero))  # warm-up
    mp = h * w / 1e6

    # (a) sustained: the whole chain between two CUDA events
    if on_card:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        acc = chain()
        end.record()
        torch.cuda.synchronize()
        dt = start.elapsed_time(end) / 1e3 / (n - 1)
        how = "the chain between two CUDA events"
    else:
        t0 = time.perf_counter()
        float(chain())
        dt = (time.perf_counter() - t0) / (n - 1)
        how = "the chain on the host clock"
    print(f"sustained ({how}): {dt * 1e3:.2f} ms/frame = {1 / dt:.1f} fps "
          f"({mp / dt:.0f} MP/s)")

    # (b) streaming: frame by frame, one synchronise (the read-back) at the end
    t0 = time.perf_counter()
    acc = chain()
    float(acc)
    dt = (time.perf_counter() - t0) / (n - 1)
    print(f"streaming (launch per frame, one synchronise at the end): {dt * 1e3:.2f} "
          f"ms/frame = {1 / dt:.1f} fps ({mp / dt:.0f} MP/s)")


if __name__ == "__main__":
    main()
