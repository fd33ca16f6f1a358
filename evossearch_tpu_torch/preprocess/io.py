"""Image loading for the indexing pipeline.

JPEGs go through the package's native libjpeg decoder
(``evossearch_tpu_torch/native``) when it is built with libjpeg: a
DCT-scaled decode at the cheapest 1/8..8/8 scale whose short side still
covers ``min_short_side``, threaded per batch with the GIL released, to
RGB or to planar 4:2:0 YCbCr. Everything else (PNG/BMP/WEBP, JPEGs the
native decoder rejects, or no decoder built) decodes with Pillow at full
resolution, as the JAX package's ``evossearch_tpu.preprocess.io`` does.

The extension is built at first use into the git-ignored ``_build/``;
``EVOSSEARCH_NO_NATIVE_BUILD=1`` loads a build that exists and compiles
none. When it cannot be built the host scan and the decode run without
it. Each loader takes an optional ``counts`` (a ``collections.Counter``)
and adds one per image to the route it took: ``decode_native_planar``,
``decode_native_rgb``, ``decode_pillow``; a JPEG the native decoder
rejected also counts ``decode_pillow_retry``, and an image nothing could
decode ``decode_failed``.
"""

from __future__ import annotations

import functools
import os
import subprocess
from collections import Counter
from pathlib import Path

import numpy as np

from ..utils import get_logger

log = get_logger("preprocess.io")

JPEG_SUFFIXES = (".jpg", ".jpeg")


@functools.lru_cache(maxsize=None)
def get_native():
    """The native extension module, built on first use; None when it
    cannot be built or loaded (no compiler), or when it is not built and
    ``EVOSSEARCH_NO_NATIVE_BUILD=1``. Without the libjpeg headers it holds
    the scanner alone (``has_native_decode``)."""
    from .. import native

    try:
        info = native.build(
            compile=os.environ.get("EVOSSEARCH_NO_NATIVE_BUILD") != "1"
        )
        if info["library"] is None:
            return None
        return native.load(info["library"])
    except (OSError, RuntimeError, ImportError, subprocess.SubprocessError) as e:
        log.warning("native extension unavailable, numpy scan and Pillow "
                    "decode only: %s", e)
        return None


def _decoder():
    """The native module when it carries the libjpeg decoders, else None."""
    native = get_native()
    if native is None or not hasattr(native, "decode_jpeg_planar_batch"):
        return None
    return native


def has_native_decode() -> bool:
    return _decoder() is not None


def _count(counts: Counter | None, route: str) -> None:
    if counts is not None:
        counts[route] += 1


def _pillow(path, counts: Counter | None, retry: bool = False) -> np.ndarray | None:
    """Full-resolution Pillow decode; None (counted) when it fails."""
    if retry:
        _count(counts, "decode_pillow_retry")
    try:
        arr = load_image_rgb(path, 0, fast=False)
    except Exception:  # undecodable file: skipped by the caller
        _count(counts, "decode_failed")
        return None
    _count(counts, "decode_pillow")
    return arr


def _read_jpegs(paths, fast: bool, decoder, out: list, counts):
    """Split ``paths`` into native-decodable JPEG bytes and the rest
    (decoded here with Pillow into ``out``). Returns (positions, bytes)."""
    positions, blobs = [], []
    for pos, path in enumerate(paths):
        if fast and decoder is not None and Path(path).suffix.lower() in JPEG_SUFFIXES:
            try:
                blobs.append(Path(path).read_bytes())
            except OSError:
                _count(counts, "decode_failed")
                continue
            positions.append(pos)
            continue
        out[pos] = _pillow(path, counts)
    return positions, blobs


def load_batch_planar(
    paths: list, min_short_side: int = 0, fast: bool = True,
    counts: Counter | None = None,
) -> list:
    """Decode a batch preferring planar 4:2:0 output for JPEGs.

    Entry types in the returned list (same order as ``paths``):
      (y, cb, cr) tuple of uint8 arrays — planar YCbCr from the native
          decoder (y: (H, W); cb/cr: (ceil(H/2), ceil(W/2))), 1.5 B/px
          for the device upload instead of RGB's 3;
      (H, W, 3) uint8 ndarray — RGB for non-JPEGs, non-YCbCr JPEGs, or
          when the native decoder is unavailable;
      None — per-image decode failure (the caller skips it).
    """
    decoder = _decoder()
    if decoder is None:
        return load_batch_rgb(paths, min_short_side, fast, counts)
    out: list = [None] * len(paths)
    positions, blobs = _read_jpegs(paths, fast, decoder, out, counts)
    if positions:
        decoded = decoder.decode_jpeg_planar_batch(blobs, min_short_side, 0)
        for pos, result in zip(positions, decoded):
            if result is None:  # a JPEG the native decoder rejects
                out[pos] = _pillow(paths[pos], counts, retry=True)
            elif len(result) == 3:  # non-YCbCr source: RGB
                h, w, rgb = result
                out[pos] = np.frombuffer(rgb, np.uint8).reshape(h, w, 3)
                _count(counts, "decode_native_rgb")
            else:
                h, w, ch, cw, y, cb, cr = result
                out[pos] = (
                    np.frombuffer(y, np.uint8).reshape(h, w),
                    np.frombuffer(cb, np.uint8).reshape(ch, cw),
                    np.frombuffer(cr, np.uint8).reshape(ch, cw),
                )
                _count(counts, "decode_native_planar")
    return out


def load_batch_rgb(
    paths: list, min_short_side: int = 0, fast: bool = True,
    counts: Counter | None = None,
) -> list[np.ndarray | None]:
    """Decode a batch of files to (H, W, 3) uint8; None entries mark
    per-image failures (the caller skips them). JPEGs go through the
    native threaded batch decoder, everything else through Pillow."""
    decoder = _decoder()
    out: list[np.ndarray | None] = [None] * len(paths)
    positions, blobs = _read_jpegs(paths, fast, decoder, out, counts)
    if positions:
        decoded = decoder.decode_jpeg_batch(blobs, min_short_side, 0)
        for pos, result in zip(positions, decoded):
            if result is None:  # a JPEG the native decoder rejects
                out[pos] = _pillow(paths[pos], counts, retry=True)
            else:
                h, w, rgb = result
                out[pos] = np.frombuffer(rgb, np.uint8).reshape(h, w, 3)
                _count(counts, "decode_native_rgb")
    return out


def load_image_rgb(
    path: str | os.PathLike, min_short_side: int = 0, fast: bool = True,
    counts: Counter | None = None,
) -> np.ndarray:
    """Decode to an (H, W, 3) uint8 RGB array.

    ``min_short_side`` > 0 allows a DCT-scaled JPEG decode (native decoder
    only); 0 decodes at full resolution everywhere. Raises on undecodable
    files — the builder's per-image error skip handles that.
    """
    path = Path(path)
    if fast and path.suffix.lower() in JPEG_SUFFIXES:
        decoder = _decoder()
        if decoder is not None:
            try:
                h, w, rgb = decoder.decode_jpeg(path.read_bytes(), min_short_side)
            except ValueError:  # a JPEG the native decoder rejects
                _count(counts, "decode_pillow_retry")
            else:
                _count(counts, "decode_native_rgb")
                return np.frombuffer(rgb, np.uint8).reshape(h, w, 3)
    from PIL import Image

    with Image.open(path) as img:
        img.load()
        if img.mode != "RGB":
            img = img.convert("RGB")
        arr = np.asarray(img, dtype=np.uint8)
    _count(counts, "decode_pillow")
    return arr
