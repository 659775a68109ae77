"""Middlebury .flo optical-flow file IO.

Same on-disk format the reference reads/writes (me_test.py:12-44): a
'PIEH' float tag (202021.25), int32 width/height, then row-major
interleaved (u, v) float32 pairs.

A copy of the JAX package's ``utils/flo.py`` without its optional native
decoder: the NumPy path, which that module keeps as its oracle.
"""

from __future__ import annotations

import os

import numpy as np

TAG_FLOAT = 202021.25
TAG_STRING = b"PIEH"


def read_flo(path: str) -> np.ndarray:
    """Read a .flo file -> float32 flow of shape [H, W, 2] (u, v)."""
    with open(path, "rb") as f:
        raw = f.read()
    return decode_flo(raw)


def decode_flo(raw: bytes) -> np.ndarray:
    tag = np.frombuffer(raw, np.float32, count=1)[0]
    if tag != np.float32(TAG_FLOAT):
        raise ValueError(f"invalid .flo tag {tag!r}")
    w = int(np.frombuffer(raw, np.int32, count=1, offset=4)[0])
    h = int(np.frombuffer(raw, np.int32, count=1, offset=8)[0])
    data = np.frombuffer(raw, np.float32, count=2 * w * h, offset=12)
    return data.reshape(h, w, 2).copy()


def write_flo(flow: np.ndarray, path: str) -> None:
    """Write a [H, W, 2] float32 flow to a .flo file."""
    flow = np.asarray(flow, dtype=np.float32)
    if flow.ndim != 3 or flow.shape[2] != 2:
        raise ValueError(f"flow must be [H, W, 2], got {flow.shape}")
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        f.write(TAG_STRING)
        np.array([w, h], dtype=np.int32).tofile(f)
        flow.astype(np.float32).tofile(f)


def flo_exists(name: str) -> bool:
    return os.path.isfile(name)
