"""The yardstick's arithmetic: the chip's published peaks and the FLOPs and
bytes the work needs, counted from shapes.

The tower formulas are copies of ``_vit_fwd_flops``, ``_resnet_fwd_flops``
and ``_text_fwd_flops`` in ``evossearch_tpu_torch/bench.py`` (kept here so
that no later change to the program moves the yardstick); they take the
configuration's ``model`` block (``portbench/configs/<config>.json``).
"""

from __future__ import annotations

from portbench.data import family

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


def resnet_fwd_flops(model: dict) -> float:
    """Forward FLOPs per image of a modified-ResNet image tower: the convs
    and the attention pool's projections."""
    s = model["image_size"] // 2  # stem convs run at half resolution
    w = model["vision_width"]
    f = (2 * s * s * 9 * 3 * (w // 2)
         + 2 * s * s * 9 * (w // 2) * (w // 2)
         + 2 * s * s * 9 * (w // 2) * w)
    s //= 2  # stem avg pool
    cin = w
    for i, n_blocks in enumerate(model["vision_layers"]):
        planes = w * (2 ** i)
        stride = 1 if i == 0 else 2
        s_out = s // stride
        for b in range(n_blocks):
            c_in = cin if b == 0 else planes * 4
            sp_in = s if b == 0 else s_out
            f += 2 * sp_in * sp_in * c_in * planes  # conv1 1x1
            f += 2 * sp_in * sp_in * 9 * planes * planes  # conv2 3x3
            f += 2 * s_out * s_out * planes * planes * 4  # conv3 1x1
            if b == 0:
                f += 2 * s_out * s_out * c_in * planes * 4  # shortcut conv
        cin, s = planes * 4, s_out
    c, t = w * 32, (model["image_size"] // 32) ** 2 + 1
    f += 2 * c * c + 2 * 2 * t * c * c  # q (1 token) + k/v projections
    f += 2 * c * model["embed_dim"]  # c_proj
    return f


def image_fwd_flops(model: dict) -> float:
    """Forward FLOPs per image of the configuration's image tower, by its
    ``family`` (``vit`` where the key is absent)."""
    return (resnet_fwd_flops if family(model) == "resnet" else vit_fwd_flops)(model)


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
