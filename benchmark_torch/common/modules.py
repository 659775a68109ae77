"""The harness's parts found by name: a module of the benchmark's folder
loaded from its file, and the content of a mix's items,
``content/<content>.py``. It imports nothing else of the harness, so that
the traffic generator and the harness both load through it."""

from __future__ import annotations

import importlib.util
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_module(path: str, name: str):
    """The module in the file ``path``, loaded under ``name``."""
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_content(content: str):
    """``content/<content>.py``: ``make(gen, n, h, w, device)`` and ``PLANES``."""
    return load_module(os.path.join(BENCH_DIR, "content", f"{content}.py"),
                       f"benchmark_torch.content.{content}")
