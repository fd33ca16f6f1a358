"""Thumbnail service (component H): base64 JPEG inline in JSON responses.

Same output contract as the reference (oldapp.py:2014-2020: PIL thumbnail
(400,400) LANCZOS -> JPEG quality 85 -> base64), deduplicated into one
helper instead of three copies. One deliberate fix: non-RGB images (RGBA
PNG, palette GIF-style PNGs) are converted before JPEG encode — the
reference raises inside PIL and silently drops those results.
"""

from __future__ import annotations

import base64
import os
import threading
from collections import OrderedDict
from io import BytesIO

from PIL import Image

# Thumbnailing dominates /search latency at k=48 (the reference recomputes
# every thumbnail on every request, oldapp.py:2014-2020). Cache encoded
# thumbnails keyed by (path, mtime, size, params); ~50KB each, so the
# default cap costs ~100MB and absorbs repeated searches over a corpus.
_CACHE_CAP = 2048
_cache: "OrderedDict[tuple, str]" = OrderedDict()
_cache_lock = threading.Lock()


def _render(image_path: str, size: tuple[int, int], quality: int) -> str:
    img = Image.open(image_path)
    # Convert BEFORE thumbnailing: Pillow silently substitutes NEAREST
    # for the requested filter on palette ('P') images, so a P-mode PNG
    # thumbnailed first gets a jagged nearest-neighbor downscale no
    # matter what filter is passed. (The convert is itself a deliberate
    # reference fix — see the module docstring.)
    if img.mode not in ("RGB", "L"):
        img = img.convert("RGB")
    img.thumbnail(size, Image.Resampling.LANCZOS)
    buffer = BytesIO()
    img.save(buffer, format="JPEG", quality=quality)
    return base64.b64encode(buffer.getvalue()).decode()


def thumbnail_b64(
    image_path: str, size: tuple[int, int] = (400, 400), quality: int = 85
) -> str:
    stat = os.stat(image_path)  # raises for missing files (caller skips)
    key = (image_path, stat.st_mtime, stat.st_size, size, quality)
    with _cache_lock:
        cached = _cache.get(key)
        if cached is not None:
            _cache.move_to_end(key)
            return cached
    encoded = _render(image_path, size, quality)
    with _cache_lock:
        _cache[key] = encoded
        _cache.move_to_end(key)
        while len(_cache) > _CACHE_CAP:
            _cache.popitem(last=False)
    return encoded
