"""What the example scripts share: the ``--device`` flag, the optional
decoders and the output directory.

cv2 and PIL are optional: a script that finds neither says on stdout what it
left out. PNG needs neither (``oclcomputervision_tpu_torch.utils.png``);
other formats, the assets' JPEG among them, need one of the two.
"""

from __future__ import annotations

import importlib
import os

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_DIR = os.path.join(REPO, "out", "examples_torch")  # git-ignored


def add_device_flag(ap) -> None:
    ap.add_argument("--device", default=None,
                    help="'cuda' or 'cpu' (default: the card; fails without one)")


def device_of(args):
    """The run's torch device: ``--device``, else the card (which raises
    without one: no fallback to the CPU)."""
    from oclcomputervision_tpu_torch._device import as_device

    return as_device(args.device)


def device_label(dev) -> str:
    import torch

    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def optional(name: str):
    """The module ``name``, or None where it is not installed."""
    try:
        return importlib.import_module(name)
    except ImportError:
        return None


def read_rgb(path: str):
    """RGB uint8 [H, W, 3] of an image file, or None where no installed
    decoder reads it: an RGB PNG through the port's reader, anything else
    through cv2 or PIL."""
    from oclcomputervision_tpu_torch.utils import read_png

    if path.lower().endswith(".png"):
        return read_png(path)
    cv2 = optional("cv2")
    if cv2 is not None:
        bgr = cv2.imread(path, cv2.IMREAD_COLOR)
        if bgr is None:
            raise FileNotFoundError(path)
        return np.ascontiguousarray(bgr[..., ::-1])
    pil = optional("PIL.Image")
    if pil is not None:
        with pil.open(path) as im:
            return np.asarray(im.convert("RGB"))
    return None
