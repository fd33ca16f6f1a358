"""Image loading for the indexing pipeline — Pillow decode only.

Counterpart of ``evossearch_tpu/preprocess/io.py`` without its native
libjpeg extension: every file decodes through PIL at full resolution, the
JAX package's behaviour with ``FAST_DECODE`` off. ``min_short_side`` and
``fast`` are accepted for call compatibility and change nothing here.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np


def load_batch_rgb(
    paths: list, min_short_side: int = 0, fast: bool = True
) -> list[np.ndarray | None]:
    """Decode a batch of files; None entries mark per-image failures
    (the caller skips them)."""
    out: list[np.ndarray | None] = []
    for path in paths:
        try:
            out.append(load_image_rgb(path, min_short_side, fast))
        except Exception:  # undecodable file: skipped by the caller
            out.append(None)
    return out


def load_image_rgb(
    path: str | os.PathLike, min_short_side: int = 0, fast: bool = True
) -> np.ndarray:
    """Decode to an (H, W, 3) uint8 RGB array. Raises on undecodable
    files — the builder's per-image error skip handles that."""
    from PIL import Image

    img = Image.open(Path(path))
    img.load()
    if img.mode != "RGB":
        img = img.convert("RGB")
    return np.asarray(img, dtype=np.uint8)
