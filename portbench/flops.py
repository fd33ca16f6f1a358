"""The yardstick's arithmetic: the chip's published peaks and the FLOPs and
bytes the work needs, counted from shapes.

The two tower formulas are copies of ``_vit_fwd_flops`` and
``_text_fwd_flops`` in ``evossearch_tpu_torch/bench.py`` (kept here so that
no later change to the program moves the yardstick); they take the
configuration's ``model`` block (``portbench/configs/<config>.json``).
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates at the full 700 W power limit.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12


def vit_fwd_flops(model: dict) -> float:
    """Forward FLOPs per image of a ViT image tower: QKVO, attention and
    MLP products per layer, the patch embedding and the projection."""
    grid = model["image_size"] // model["patch_size"]
    t = grid * grid + 1
    w = model["vision_width"]
    per_layer = 24 * t * w * w + 4 * t * t * w
    patch = 2 * t * (model["patch_size"] ** 2 * 3) * w
    proj = 2 * w * model["embed_dim"]
    return model["vision_layers"] * per_layer + patch + proj


def text_fwd_flops(model: dict) -> float:
    """Forward FLOPs per caption of the text tower at all
    ``context_length`` positions (the projection of the pooled token
    only)."""
    t, w = model["context_length"], model["text_width"]
    return model["text_layers"] * (24 * t * w * w + 4 * t * t * w) + 2 * w * model["embed_dim"]


def scan_flops(rows: int, dim: int) -> float:
    """FLOPs of one query's exact scan: a multiply and an add per element."""
    return 2.0 * rows * dim


def scan_bytes(rows: int, dim: int, queries: int, k: int, row_bytes: int = 2) -> float:
    """Bytes one top-k dispatch must move at least: every corpus row read
    once, the float32 queries read once, and (score, index) pairs plus a
    flag written once per query."""
    return rows * dim * row_bytes + queries * dim * 4 + queries * (2 * k + 1) * 4
