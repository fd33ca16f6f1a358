"""PIL-faithful antialiased bicubic resampling as dense weight matrices.

The reference preprocess (CLIP's `_transform`, invoked at oldapp.py:32/40)
is: PIL bicubic resize of the shorter side to 224, then center-crop 224.
Both steps are linear maps along each image axis, so the whole thing is
``out = A_h @ img @ A_w.T`` with per-axis weight matrices — which turns the
preprocess into two GEMMs that run on the TPU MXU with static shapes
regardless of the source image size (weights are computed host-side per
source size, zero-padded to a static maximum).

Weight construction reproduces Pillow's Resample.c "precompute_coeffs":
cubic kernel a=-0.5 with support 2, kernel stretched by the scale factor
when downscaling (antialias), per-output-pixel normalization. The center
crop is folded in by shifting sample centers by the crop offset, so only
224 output rows/cols are ever computed.
"""

from __future__ import annotations

import functools
import math

import numpy as np

_BICUBIC_A = -0.5
_SUPPORT = 2.0


def _cubic_kernel(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    a = _BICUBIC_A
    return np.where(
        x <= 1.0,
        ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0,
        np.where(x < 2.0, (((x - 5.0) * x + 8.0) * x - 4.0) * a, 0.0),
    )


def resized_dims(height: int, width: int, target: int) -> tuple[int, int]:
    """Shorter-side resize dims, matching torchvision's int truncation."""
    if height <= width:
        return target, max(target, int(target * width / height))
    return max(target, int(target * height / width)), target


def crop_offset(resized: int, crop: int) -> float:
    """Center-crop start offset along one axis (torchvision rounding)."""
    return float(int(round((resized - crop) / 2.0)))


def _build_weights(
    scale: float, in_size: int, crop_start: float, crop_size: int
) -> np.ndarray:
    """Pillow's ``precompute_coeffs`` row loop — ONE home for it, shared
    by the luma and chroma matrices so a fix to the normalization/
    truncation semantics cannot silently miss one of them. Row r's
    kernel centers at ``(crop_start + r + 0.5) * scale`` on the input
    grid, antialias-stretched by ``max(scale, 1)``."""
    filterscale = max(scale, 1.0)
    support = _SUPPORT * filterscale
    weights = np.zeros((crop_size, in_size), dtype=np.float64)
    for r in range(crop_size):
        center = (crop_start + r + 0.5) * scale
        xmin = max(0, int(center - support + 0.5))
        xmax = min(in_size, int(center + support + 0.5))
        xs = np.arange(xmin, xmax, dtype=np.float64)
        w = _cubic_kernel((xs + 0.5 - center) / filterscale)
        total = w.sum()
        if total != 0.0:
            w /= total
        weights[r, xmin:xmax] = w
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=4096)
def resample_matrix(
    in_size: int, out_size: int, crop_start: float = 0.0, crop_size: int | None = None
) -> np.ndarray:
    """(crop_size, in_size) float32 weights for resize-then-crop on one axis.

    Row r holds the bicubic weights producing output pixel ``crop_start + r``
    of an ``in_size -> out_size`` PIL bicubic resize; taking only crop_size
    rows implements the center crop for free.
    """
    crop_size = out_size if crop_size is None else crop_size
    return _build_weights(in_size / out_size, in_size, crop_start, crop_size)


@functools.lru_cache(maxsize=4096)
def chroma_resample_matrix(
    full_in: int,
    chroma_in: int,
    out_size: int,
    crop_start: float = 0.0,
    crop_size: int | None = None,
) -> np.ndarray:
    """(crop_size, chroma_in) weights resampling a half-resolution 4:2:0
    chroma plane straight to the full-resolution resize+crop output grid.

    The planar JPEG path (native decode_jpeg_planar) ships chroma at half
    the luma resolution; instead of upsampling it first (which would cost
    the very host->device bytes the planar path saves), the upsample is
    folded into the resize GEMM. Chroma sample ``i`` sits at full-res
    coordinate ``2*(i + 0.5)`` (centered 4:2:0 siting), so output pixel
    ``crop_start + r`` of the luma resize — full-res position
    ``(crop_start + r + 0.5) * scale`` — lands at chroma-grid position
    ``.../2``, with the antialias filter stretched by ``scale/2`` (chroma
    upsamples whenever the luma resize downsamples by less than 2x).
    """
    crop_size = out_size if crop_size is None else crop_size
    return _build_weights(
        full_in / out_size / 2.0, chroma_in, crop_start, crop_size
    )


def clip_resize_crop_chroma_matrices(
    height: int, width: int, ch: int, cw: int, target: int = 224
) -> tuple[np.ndarray, np.ndarray]:
    """Chroma counterparts of clip_resize_crop_matrices: (target, ch) and
    (target, cw) matrices mapping the half-res chroma planes of an
    (height, width) image onto the SAME resize+crop output grid as the
    luma matrices, so ``A_hc @ chroma @ A_wc.T`` aligns pixel-for-pixel
    with ``A_h @ luma @ A_w.T``."""
    rh, rw = resized_dims(height, width, target)
    a_hc = chroma_resample_matrix(height, ch, rh, crop_offset(rh, target), target)
    a_wc = chroma_resample_matrix(width, cw, rw, crop_offset(rw, target), target)
    return a_hc, a_wc


def clip_resize_crop_matrices(
    height: int, width: int, target: int = 224
) -> tuple[np.ndarray, np.ndarray]:
    """Per-axis weight matrices for the full CLIP resize+center-crop.

    Returns (A_h of shape (target, height), A_w of shape (target, width))
    such that ``A_h @ img @ A_w.T`` equals bicubic-resize-shorter-side-to-
    target followed by center-crop(target).
    """
    rh, rw = resized_dims(height, width, target)
    a_h = resample_matrix(height, rh, crop_offset(rh, target), target)
    a_w = resample_matrix(width, rw, crop_offset(rw, target), target)
    return a_h, a_w


def _support_window(mat: np.ndarray) -> tuple[int, int]:
    """[lo, hi) input-column span holding every nonzero weight of a
    (out, in) resample matrix — the only source pixels the output ever
    reads."""
    cols = np.flatnonzero(mat.any(axis=0))
    if cols.size == 0:  # degenerate all-zero matrix: keep full span
        return 0, mat.shape[1]
    return int(cols[0]), int(cols[-1]) + 1


def clip_resize_crop_windowed(
    height: int, width: int, target: int = 224
) -> tuple[np.ndarray, np.ndarray, int, int]:
    """clip_resize_crop_matrices sliced to the bicubic support window.

    The center crop means the cropped (longer) axis only ever reads a
    centered band of the source: every column outside it carries an
    exactly-zero weight. Slicing those columns off BOTH the matrix and
    the canvas drops only exact-0.0 terms — the result is mathematically
    identical (any f32 delta is last-ulp summation-order noise from the
    shorter contraction) — while cutting host->device canvas bytes
    by the crop ratio — ~24% on 4:3 sources, ~42% on 16:9 (the dominant
    indexing cost on upload-bound rigs; VERDICT r3 #4).

    Returns (A_h[:, y0:y1], A_w[:, x0:x1], y0, x0); the caller packs
    ``img[y0:y0+A_h.shape[1], x0:x0+A_w.shape[1]]`` into its canvas.
    """
    a_h, a_w = clip_resize_crop_matrices(height, width, target)
    y0, y1 = _support_window(a_h)
    x0, x1 = _support_window(a_w)
    return a_h[:, y0:y1], a_w[:, x0:x1], y0, x0


def clip_resize_crop_chroma_windowed(
    height: int, width: int, ch: int, cw: int, target: int = 224
) -> tuple[np.ndarray, np.ndarray, int, int]:
    """Windowed clip_resize_crop_chroma_matrices (see
    clip_resize_crop_windowed): the chroma planes get their own support
    window on the half-resolution grid."""
    a_hc, a_wc = clip_resize_crop_chroma_matrices(height, width, ch, cw, target)
    cy0, cy1 = _support_window(a_hc)
    cx0, cx1 = _support_window(a_wc)
    return a_hc[:, cy0:cy1], a_wc[:, cx0:cx1], cy0, cx0


def resample_reference(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Pure-numpy oracle: full resize of an (H, W, C) float image."""
    a_h = resample_matrix(img.shape[0], out_h)
    a_w = resample_matrix(img.shape[1], out_w)
    return np.einsum("hH,HWc,wW->hwc", a_h, img.astype(np.float64), a_w)
