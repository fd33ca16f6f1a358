"""Batched image preprocessing pipeline: host decode -> device fused
resize + center-crop + normalize. PyTorch counterpart of
``evossearch_tpu/preprocess/pipeline.py``.

  host:   decode -> RGB uint8, pack into a batch-sized canvas, fetch cached
          per-unique-size resize/crop weight matrices (prepare_batch)
  device: matrix gather + two resampling GEMMs + /255 + CLIP mean/std
          normalize, over the whole batch (device_preprocess_indexed)

The planar twin (prepare_batch_planar, device_preprocess_planar_indexed)
takes the native decoder's 4:2:0 planes: a luma canvas and a half-size
Cb/Cr canvas, resampled onto one output grid, then BT.601 YCbCr -> RGB on
the device.

Weight matrices are zero-padded to the canvas dims (padded canvas pixels
get zero weight so they never influence the output), and canvas shapes are
drawn from a bounded ladder, as in the JAX package. Images larger than the
canvas are pre-shrunk host-side with the SAME resampling algorithm.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.constants import CLIP_IMAGE_MEAN, CLIP_IMAGE_STD
from .resize import (
    clip_resize_crop_chroma_windowed,
    clip_resize_crop_windowed,
    resample_matrix,
)

DEFAULT_MAX_SIDE = 1024


def _host_shrink(arr: np.ndarray, max_side: int, target: int) -> np.ndarray:
    """Pre-shrink an oversized image with the same bicubic algorithm.

    The final transform is resize-shorter-side + CENTER CROP, so only a
    centered, roughly short-side-wide band of the long axis can ever
    reach the output; the band is cropped FIRST (short side + the
    bicubic support margins of both resample stages), so the long side
    of a panorama cannot drive the scale below the short-side floor —
    without this, a 500x8000 source was shrunk to 64x1024 by constraint
    (a) and the embedding came from a 64-px-tall blur instead of the
    reference's 224.

    The remaining scale must (a) fit both sides in the canvas, (b) never
    upscale, and is (c) allowed to shrink down to shorter-side =
    4*target for speed. PIL's uint8 pass order/quantization is mirrored
    (horizontal, round+clamp, vertical, round+clamp) for consistency
    with the device kernel.
    """
    h, w = arr.shape[:2]
    short, long_ = min(h, w), max(h, w)
    band = min(long_, short + 8 * -(-short // target) + 64)
    if long_ > band:
        if h >= w:
            off = (h - band) // 2
            arr = arr[off : off + band]
        else:
            off = (w - band) // 2
            arr = arr[:, off : off + band]
        h, w = arr.shape[:2]
    scale = min(1.0, max_side / max(h, w), 4 * target / min(h, w))
    nh = min(max_side, max(1, int(h * scale)))
    nw = min(max_side, max(1, int(w * scale)))
    return host_apply_resample(arr, resample_matrix(h, nh), resample_matrix(w, nw))


def _route_oversized(arr: np.ndarray, max_side: int, target: int) -> np.ndarray:
    """The image itself, or its host pre-shrink when it cannot ride the
    canvas ladder.

    Routing is by the bicubic SUPPORT WINDOW, not the raw dims: the
    center crop means only a centered ~short-side-wide band of the long
    axis is ever read, so a 500x8000 panorama's window is ~500x510 and
    fits the ladder — it takes the normal windowed path with
    reference-exact sampling geometry (matrices computed from the
    ORIGINAL dims). Only images whose window genuinely exceeds the
    ladder (short side > ~max_side) pay the approximate two-stage
    pre-shrink."""
    h, w = arr.shape[:2]
    if h <= max_side and w <= max_side:
        return arr
    mh, mw, _, _ = clip_resize_crop_windowed(h, w, target)
    if mh.shape[1] <= max_side and mw.shape[1] <= max_side:
        return arr
    return _host_shrink(arr, max_side, target)


def host_apply_resample(
    arr: np.ndarray, a_h: np.ndarray, a_w: np.ndarray
) -> np.ndarray:
    """Two-pass separable host resample with PIL's inter-pass round/clamp
    — the same math ``device_preprocess`` runs on device. ONE home for it
    so host pre-shrink and the training loader can't drift from the
    device stage."""
    h, _, c = arr.shape
    # the JAX package's einsums as BLAS products: (s, w) @ (h, w, c) and
    # (t, h) @ (h, s*c); numpy's einsum does not hand these contractions
    # to BLAS
    out = np.matmul(a_w, arr.astype(np.float32))  # (h, s, c)
    out = np.clip(np.round(out), 0, 255)
    out = (a_h @ out.reshape(h, -1)).reshape(a_h.shape[0], -1, c)
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def device_preprocess(canvases: torch.Tensor, a_h: torch.Tensor,
                      a_w: torch.Tensor, out_dtype: torch.dtype | None = None):
    """Fused resample + crop + normalize on the tensors' device.

    canvases: (B, MAX, MAX, 3) uint8;  a_h/a_w: (B, target, MAX) float32.
    Returns (B, target, target, 3) in ``out_dtype`` (default float32),
    normalized with the CLIP mean/std.

    Pass order and quantization mirror PIL's uint8 resampling pipeline
    (horizontal pass, round half to even + clamp to [0,255], vertical
    pass, round + clamp), as the JAX package does.
    """
    return _normalize(_resample2(canvases.float(), a_h, a_w), out_dtype)


def device_preprocess_indexed(canvases: torch.Tensor, a_h_unique: torch.Tensor,
                              a_w_unique: torch.Tensor, size_idx: torch.Tensor,
                              out_dtype: torch.dtype | None = None):
    """device_preprocess with per-UNIQUE-size weight matrices gathered by
    ``size_idx`` on the device (one matrix pair per distinct source size
    crosses to the device, not one per image)."""
    idx = size_idx.long()
    return device_preprocess(canvases, a_h_unique[idx], a_w_unique[idx], out_dtype)


def _normalize(rgb: torch.Tensor, out_dtype: torch.dtype | None) -> torch.Tensor:
    """uint8-valued (..., 3) RGB -> CLIP mean/std normalized values."""
    mean = torch.tensor(CLIP_IMAGE_MEAN, dtype=torch.float32, device=rgb.device) * 255.0
    std = torch.tensor(CLIP_IMAGE_STD, dtype=torch.float32, device=rgb.device) * 255.0
    x = (rgb - mean) / std
    return x if out_dtype is None else x.to(out_dtype)


def _resample2(x: torch.Tensor, a_h: torch.Tensor, a_w: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) float -> (B, T, T, C): width pass, round + clamp,
    height pass, round + clamp (PIL's uint8 pass order)."""
    x = torch.einsum("bsw,bhwc->bhsc", a_w, x)
    x = torch.round(x).clamp_(0.0, 255.0)
    x = torch.einsum("bth,bhsc->btsc", a_h, x)
    return torch.round(x).clamp_(0.0, 255.0)


def device_preprocess_planar(y: torch.Tensor, c: torch.Tensor,
                             a_h_y: torch.Tensor, a_w_y: torch.Tensor,
                             a_h_c: torch.Tensor, a_w_c: torch.Tensor,
                             out_dtype: torch.dtype | None = None):
    """Fused planar-YCbCr resample + crop + color-convert + normalize on
    the tensors' device — the device half of the planar JPEG path.

    y: (B, Hp, Wp) uint8 luma canvases; c: (B, Hpc, Wpc, 2) uint8 Cb/Cr
    canvases at about half resolution on their own pad ladder (the native
    ``decode_jpeg_planar`` 4:2:0 layout: 1.5 B/px on the wire against
    RGB's 3). a_h_y/a_w_y: (B, target, Hp/Wp) luma resize+crop weights;
    a_h_c/a_w_c: (B, target, Hpc/Wpc) chroma weights on the SAME output
    grid (``resize.clip_resize_crop_chroma_matrices`` folds the 2x chroma
    upsample into the resample). The JFIF YCbCr->RGB conversion (BT.601
    full range) is three FMAs per pixel, quantized like the uint8 RGB the
    other path carries. Matches the RGB path within a couple of 8-bit
    steps on natural images.
    """
    yf = _resample2(y.float()[..., None], a_h_y, a_w_y)[..., 0]  # (B, T, T)
    cf = _resample2(c.float(), a_h_c, a_w_c)  # (B, T, T, 2)
    cb = cf[..., 0] - 128.0
    cr = cf[..., 1] - 128.0
    rgb = torch.stack(
        [yf + 1.402 * cr, yf - 0.344136 * cb - 0.714136 * cr, yf + 1.772 * cb],
        dim=-1,
    )
    return _normalize(torch.round(rgb).clamp_(0.0, 255.0), out_dtype)


def device_preprocess_planar_indexed(
    y: torch.Tensor, c: torch.Tensor, a_h_y_u: torch.Tensor,
    a_w_y_u: torch.Tensor, a_h_c_u: torch.Tensor, a_w_c_u: torch.Tensor,
    size_idx: torch.Tensor, out_dtype: torch.dtype | None = None,
):
    """device_preprocess_planar with per-UNIQUE-size weight matrices
    gathered on the device by ``size_idx``."""
    idx = size_idx.long()
    return device_preprocess_planar(
        y, c, a_h_y_u[idx], a_w_y_u[idx], a_h_c_u[idx], a_w_c_u[idx], out_dtype
    )


# Cap on distinct source sizes per prepared batch. The per-unique-size
# resample matrices are (U, target, canvas) f32 zero-padded to the batch
# canvas — at U ~ batch_size (a scraped folder where every photo has its
# own size) a 512-image batch would build and ship ~1 GB of matrices,
# inverting the traffic win they exist for. Producers flush a batch when
# it accumulates this many distinct sizes (32 keeps the matrices under
# ~60 MB at the default canvas).
MAX_UNIQUE_SIZES = 32


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _pad_dim(n: int, base: int) -> int:
    """Canvas-dim ladder: multiples of ``base`` up to 512, multiples of
    max(base, 128) above. At the default base 64 this keeps the zero-pad
    upload waste under ~15% for DCT-scaled decodes (the old single 256
    step padded a 300-px side to 512 — 70% wasted relay bytes, the
    dominant end-to-end indexing cost on upload-bound rigs) while still
    bounding the distinct canvas shapes to 8 + 4 values per axis."""
    step = base if n <= 512 else max(base, 128)
    return -(-n // step) * step


def prepare_batch(
    arrays: list[np.ndarray],
    target: int = 224,
    pad_multiple: int = 64,
    max_side: int = DEFAULT_MAX_SIDE,
):
    """Batch of (H, W, 3) uint8 arrays -> device-ready tensors.

    Returns (canvases (B, Hp, Wp, 3) uint8, a_h_unique (U, target, Hp) f32,
    a_w_unique (U, target, Wp) f32, size_idx (B,) int32).

    Every shape the device stage sees is drawn from a SMALL ladder (the
    JAX package's, where each shape is one compile): canvas dims
    round up the two-tier ``_pad_dim`` ladder (base ``pad_multiple``) and
    the unique-size count U pads to a power of two (repeating row 0). A
    homogeneous batch still ships one matrix pair and a near-tight canvas.
    """
    for a in arrays:
        if a.ndim != 3 or a.shape[2] != 3:
            raise ValueError(f"expected (H, W, 3) uint8 images, got {a.shape}")
    shrunk = [_route_oversized(a, max_side, target) for a in arrays]
    # Canvases hold only each image's bicubic SUPPORT WINDOW — the center
    # crop zeroes every weight outside a centered band of the longer axis,
    # so the slice is dropped before upload (mathematically identical
    # output — elided terms are exact zeros; any f32 delta is summation-
    # order ulps — and ~25-40% fewer canvas bytes on photo aspect ratios).
    sizes: dict[tuple[int, int], int] = {}
    size_idx = np.zeros(len(shrunk), np.int32)
    for i, a in enumerate(shrunk):
        size_idx[i] = sizes.setdefault(a.shape[:2], len(sizes))
    win = {hw: clip_resize_crop_windowed(*hw, target) for hw in sizes}
    hp = _pad_dim(max(m[0].shape[1] for m in win.values()), pad_multiple)
    wp = _pad_dim(max(m[1].shape[1] for m in win.values()), pad_multiple)
    canvases = np.zeros((len(shrunk), hp, wp, 3), np.uint8)
    for i, a in enumerate(shrunk):
        mh, mw, y0, x0 = win[a.shape[:2]]
        bh, bw = mh.shape[1], mw.shape[1]
        canvases[i, :bh, :bw] = a[y0 : y0 + bh, x0 : x0 + bw]
    u_pad = _next_pow2(len(sizes))
    a_h = np.zeros((u_pad, target, hp), np.float32)
    a_w = np.zeros((u_pad, target, wp), np.float32)
    for hw, u in sizes.items():
        mh, mw, _, _ = win[hw]
        a_h[u, :, : mh.shape[1]] = mh
        a_w[u, :, : mw.shape[1]] = mw
    for u in range(len(sizes), u_pad):  # pad rows: duplicate row 0
        a_h[u] = a_h[0]
        a_w[u] = a_w[0]
    return canvases, a_h, a_w, size_idx


def planar_to_rgb_host(
    y: np.ndarray, cb: np.ndarray, cr: np.ndarray
) -> np.ndarray:
    """Host fallback: planar 4:2:0 -> (H, W, 3) uint8 RGB (NN chroma
    upsample + BT.601 full-range). Used only for rare images the planar
    device path can't take batched (e.g. larger than the canvas ladder's
    max side, which need the RGB host pre-shrink)."""
    h, w = y.shape
    cbu = np.repeat(np.repeat(cb, 2, 0), 2, 1)[:h, :w].astype(np.float32) - 128
    cru = np.repeat(np.repeat(cr, 2, 0), 2, 1)[:h, :w].astype(np.float32) - 128
    yf = y.astype(np.float32)
    rgb = np.stack(
        [
            yf + 1.402 * cru,
            yf - 0.344136 * cbu - 0.714136 * cru,
            yf + 1.772 * cbu,
        ],
        axis=-1,
    )
    return np.clip(np.round(rgb), 0, 255).astype(np.uint8)


def prepare_batch_planar(
    planes: list[tuple[np.ndarray, np.ndarray, np.ndarray]],
    target: int = 224,
    pad_multiple: int = 64,
):
    """Batch of (y, cb, cr) planar 4:2:0 arrays -> device-ready tensors.

    Returns (y_canvas (B, Hp, Wp) u8, c_canvas (B, Hpc, Wpc, 2) u8,
    a_h_y (U, target, Hp) f32, a_w_y (U, target, Wp) f32,
    a_h_c (U, target, Hpc) f32, a_w_c (U, target, Wpc) f32,
    size_idx (B,) int32) — the planar twin of prepare_batch, drawing every
    shape from bounded ladders (chroma dims ride their own half-step
    ladder). Callers pre-route images above the canvas ladder
    (``DEFAULT_MAX_SIDE``) to the RGB path (planar_to_rgb_host); this
    function requires them gone.
    """
    for y, cb, cr in planes:
        h, w = y.shape
        want = ((h + 1) // 2, (w + 1) // 2)
        if cb.shape != want or cr.shape != want:
            raise ValueError(
                f"chroma {cb.shape} does not match 4:2:0 of luma {(h, w)}"
            )
    n = len(planes)
    # Support-window packing (see prepare_batch): luma and chroma each get
    # their own window on their own grid, so the chroma canvas rides its
    # own (finer-stepped) ladder instead of being pinned to half the luma
    # canvas.
    sizes: dict[tuple[int, int], int] = {}
    size_idx = np.zeros(n, np.int32)
    for i, (y, cb, cr) in enumerate(planes):
        size_idx[i] = sizes.setdefault(y.shape, len(sizes))
    win: dict[tuple[int, int], tuple] = {}
    for h, w in sizes:
        mh, mw, y0, x0 = clip_resize_crop_windowed(h, w, target)
        ch, cw = (h + 1) // 2, (w + 1) // 2
        mhc, mwc, cy0, cx0 = clip_resize_crop_chroma_windowed(
            h, w, ch, cw, target
        )
        win[(h, w)] = (mh, mw, y0, x0, mhc, mwc, cy0, cx0)
    hp = _pad_dim(max(v[0].shape[1] for v in win.values()), pad_multiple)
    wp = _pad_dim(max(v[1].shape[1] for v in win.values()), pad_multiple)
    c_step = max(pad_multiple // 2, 16)
    chp = _pad_dim(max(v[4].shape[1] for v in win.values()), c_step)
    cwp = _pad_dim(max(v[5].shape[1] for v in win.values()), c_step)
    y_canvas = np.zeros((n, hp, wp), np.uint8)
    c_canvas = np.zeros((n, chp, cwp, 2), np.uint8)
    for i, (y, cb, cr) in enumerate(planes):
        mh, mw, y0, x0, mhc, mwc, cy0, cx0 = win[y.shape]
        bh, bw = mh.shape[1], mw.shape[1]
        y_canvas[i, :bh, :bw] = y[y0 : y0 + bh, x0 : x0 + bw]
        cbh, cbw = mhc.shape[1], mwc.shape[1]
        c_canvas[i, :cbh, :cbw, 0] = cb[cy0 : cy0 + cbh, cx0 : cx0 + cbw]
        c_canvas[i, :cbh, :cbw, 1] = cr[cy0 : cy0 + cbh, cx0 : cx0 + cbw]
    u_pad = _next_pow2(len(sizes))
    a_h_y = np.zeros((u_pad, target, hp), np.float32)
    a_w_y = np.zeros((u_pad, target, wp), np.float32)
    a_h_c = np.zeros((u_pad, target, chp), np.float32)
    a_w_c = np.zeros((u_pad, target, cwp), np.float32)
    for hw, u in sizes.items():
        mh, mw, _, _, mhc, mwc, _, _ = win[hw]
        a_h_y[u, :, : mh.shape[1]] = mh
        a_w_y[u, :, : mw.shape[1]] = mw
        a_h_c[u, :, : mhc.shape[1]] = mhc
        a_w_c[u, :, : mwc.shape[1]] = mwc
    for u in range(len(sizes), u_pad):  # pad rows: duplicate row 0
        a_h_y[u] = a_h_y[0]
        a_w_y[u] = a_w_y[0]
        a_h_c[u] = a_h_c[0]
        a_w_c[u] = a_w_c[0]
    return y_canvas, c_canvas, a_h_y, a_w_y, a_h_c, a_w_c, size_idx
