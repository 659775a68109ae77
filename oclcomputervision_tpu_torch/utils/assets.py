"""Paths of the repository's vendored test and demo assets (``assets/`` at
the repository root, beside this package)."""

from __future__ import annotations

import os

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ASSETS_DIR = os.path.join(_REPO_ROOT, "assets")


def asset_path(name: str) -> str:
    return os.path.join(ASSETS_DIR, name)
