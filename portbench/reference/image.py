"""CLIP's image preprocessing along the decode route the port documents
for JPEGs (``evossearch_tpu_torch/preprocess/io.py`` and ``pipeline.py``,
``native/evossearch_native.cpp:decode_one_planar``), written plainly:

1. A DCT-scaled libjpeg decode at the smallest scale n/8 whose short side
   still covers the target (224), to YCbCr with no colour conversion.
   Here through Pillow's ``draft("YCbCr", ...)``, which offers the scales
   1/8, 1/4, 1/2 and 1; a scale outside those raises. For a 4:2:0 file at
   a reduced scale libjpeg IDCTs the chroma at the output resolution, so
   no chroma upsampling takes place.
2. Chroma brought to the 4:2:0 grid by a 2x2 box average rounded as
   ``(sum + 2) >> 2``, the duplicate row or column standing in past an
   odd edge. At full scale (n = 8, a target above an eighth less than
   the short side, as 448 for 480 rows) the port reads the file's own
   4:2:0 chroma samples; Pillow's full-scale decode upsamples them with
   libjpeg's fancy filter, which no box average undoes, so the chroma
   comes from a decode at scale 1/2 instead, where libjpeg IDCTs the
   chroma blocks at their own 8x8 size: the file's samples.
3. CLIP's transform (``clip/clip.py:_transform``: bicubic resize of the
   shorter side to 224, centre crop) as Pillow computes it
   (``Resample.c``, ``precompute_coeffs``: cubic a = -0.5, support 2
   stretched by the scale when shrinking, weights normalised per output
   pixel), one axis at a time (width, then height) with rounding to
   integers and clamping to [0, 255] after each pass. Chroma sample i
   sits at full-resolution coordinate 2(i + 0.5), so the chroma planes
   resample straight onto the luma's output grid at half the scale.
4. JFIF (BT.601 full range) YCbCr -> RGB, rounded and clamped, then
   CLIP's mean and standard deviation.

This is the port's route by design, not a full decode and resize (which
the port's route differs from by cosine 0.99887, PERF.md): the check
holds the program's embeddings to what its own documented route gives.
"""

from __future__ import annotations

import functools
import math

import numpy as np

MEAN = np.array([0.48145466, 0.4578275, 0.40821073]) * 255.0
STD = np.array([0.26862954, 0.26130258, 0.27577711]) * 255.0


def dct_scale(height: int, width: int, target: int) -> int:
    """The numerator n of the decode scale n/8: the smallest whose scaled
    short side covers ``target``."""
    short = min(height, width)
    for n in range(1, 9):
        if short * n // 8 >= target:
            return n
    return 8


def _cubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0,
                    np.where(x < 2.0, (((x - 5.0) * x + 8.0) * x - 4.0) * a, 0.0))


@functools.lru_cache(maxsize=64)
def resample_weights(in_size: int, scale: float, crop_start: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) float64 weights: output pixel r of a bicubic
    resize by 1/scale, counted from the crop's start."""
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    out = np.zeros((out_size, in_size))
    for r in range(out_size):
        center = (crop_start + r + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), in_size)
        xs = np.arange(lo, hi)
        wts = _cubic((xs + 0.5 - center) / filterscale)
        if wts.sum() != 0.0:
            wts = wts / wts.sum()
        out[r, lo:hi] = wts
    return out


def _axis(full: int, resized: int, target: int) -> tuple[float, int]:
    """(scale, crop start) of one axis of CLIP's resize and centre crop."""
    return full / resized, int(round((resized - target) / 2.0))


def _pass(plane: np.ndarray, a_h: np.ndarray, a_w: np.ndarray) -> np.ndarray:
    """One (h, w) plane: width pass, round and clamp, height pass, round
    and clamp."""
    x = np.clip(np.round(plane @ a_w.T), 0, 255)
    return np.clip(np.round(a_h @ x), 0, 255)


def preprocess(path: str, target: int = 224) -> np.ndarray:
    """A JPEG file -> (target, target, 3) float32 normalised pixels."""
    from PIL import Image, JpegImagePlugin

    with Image.open(path) as img:
        w0, h0 = img.size
        n = dct_scale(h0, w0, target)
        if n not in (1, 2, 4, 8):
            raise ValueError(f"decode scale {n}/8 has no Pillow draft")
        img.draft("YCbCr", (math.ceil(w0 * n / 8), math.ceil(h0 * n / 8)))
        if img.mode != "YCbCr":
            raise ValueError(f"{path}: not a YCbCr JPEG ({img.mode})")
        ycc = np.asarray(img, dtype=np.int64)
        full_420 = n == 8 and JpegImagePlugin.get_sampling(img) == 2
    h, w = ycc.shape[:2]
    y = ycc[:, :, 0].astype(np.float64)
    if full_420:
        with Image.open(path) as img:
            img.draft("YCbCr", (math.ceil(w0 / 2), math.ceil(h0 / 2)))
            c = np.asarray(img, dtype=np.int64)[:, :, 1:]
        if c.shape[:2] != ((h + 1) // 2, (w + 1) // 2):
            raise ValueError(f"{path}: chroma planes {c.shape[:2]} at scale 1/2")
    else:
        c = ycc[:, :, 1:]
        c = np.concatenate([c, c[-1:]], 0) if h % 2 else c
        c = np.concatenate([c, c[:, -1:]], 1) if w % 2 else c
        c = (c[0::2, 0::2] + c[0::2, 1::2] + c[1::2, 0::2] + c[1::2, 1::2] + 2) >> 2
    if h <= w:
        rh, rw = target, max(target, int(target * w / h))
    else:
        rh, rw = max(target, int(target * h / w)), target
    sh, ch0 = _axis(h, rh, target)
    sw, cw0 = _axis(w, rw, target)
    yo = _pass(y, resample_weights(h, sh, ch0, target), resample_weights(w, sw, cw0, target))
    a_hc = resample_weights(c.shape[0], sh / 2.0, ch0, target)
    a_wc = resample_weights(c.shape[1], sw / 2.0, cw0, target)
    cb, cr = (_pass(c[..., i].astype(np.float64), a_hc, a_wc) - 128.0 for i in (0, 1))
    rgb = np.stack([yo + 1.402 * cr, yo - 0.344136 * cb - 0.714136 * cr, yo + 1.772 * cb], -1)
    rgb = np.clip(np.round(rgb), 0, 255)
    return ((rgb - MEAN) / STD).astype(np.float32)
