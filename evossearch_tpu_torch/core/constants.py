"""CLIP model constants and architecture table.

The numeric constants reproduce the OpenAI CLIP release so that converted
checkpoints are numerically faithful (reference usage: oldapp.py:28 loads
`clip.load(config.CLIP_MODEL)`; the preprocessing constants live inside the
upstream `clip` package's `_transform`).
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar

# torchvision.transforms.Normalize constants used by OpenAI CLIP's preprocess.
CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)

# Text tokenizer constants (OpenAI byte-BPE release).
CLIP_VOCAB_SIZE = 49408
CLIP_CONTEXT_LENGTH = 77
CLIP_SOT_TOKEN = 49406  # <|startoftext|>
CLIP_EOT_TOKEN = 49407  # <|endoftext|>


@dataclasses.dataclass(frozen=True)
class CLIPModelSpec:
    """Architecture hyperparameters for one CLIP ViT variant."""

    family: ClassVar[str] = "vit"

    name: str
    # Vision tower
    image_size: int
    patch_size: int
    vision_width: int
    vision_layers: int
    vision_heads: int
    # Text tower
    text_width: int
    text_layers: int
    text_heads: int
    vocab_size: int
    context_length: int
    # Joint space
    embed_dim: int

    @property
    def grid_size(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_image_tokens(self) -> int:
        return self.grid_size * self.grid_size + 1  # + class token


@dataclasses.dataclass(frozen=True)
class CLIPResNetSpec:
    """Architecture hyperparameters for one CLIP modified-ResNet variant.

    OpenAI's "modified" ResNet differs from torchvision's: a 3-conv stem
    (each followed by BN+ReLU) with a trailing 2x2 average pool, strided
    downsampling replaced by average-pool-then-conv (anti-aliased, both in
    the residual branch and the shortcut), and global average pooling
    replaced by a single-query QKV attention pool. The reference reaches
    these models through `clip.load(config.CLIP_MODEL)` (oldapp.py:28,
    config.py:25) — any of RN50/RN101/RN50x4/RN50x16/RN50x64 is a valid
    EVOSSEARCH_CLIP_MODEL there, so capability parity requires the family.
    """

    family: ClassVar[str] = "resnet"

    name: str
    # Vision tower
    image_size: int
    vision_width: int  # stem width; stage c block channels = w, 2w, 4w, 8w
    vision_layers: tuple[int, int, int, int]  # Bottleneck blocks per stage
    vision_heads: int  # attention-pool heads (OpenAI: width * 32 // 64)
    # Text tower (same transformer as the ViT variants)
    text_width: int
    text_layers: int
    text_heads: int
    vocab_size: int
    context_length: int
    # Joint space
    embed_dim: int

    def __post_init__(self):
        # JSON round-trips (checkpoint.py) deliver lists; keep it hashable.
        object.__setattr__(self, "vision_layers", tuple(self.vision_layers))

    @property
    def spacial_dim(self) -> int:
        # total downsampling 32x: stem conv (2x) + stem pool (2x) + 3
        # strided stages (8x). sic "spacial": OpenAI's spelling.
        return self.image_size // 32

    @property
    def attn_dim(self) -> int:
        return self.vision_width * 32  # stage-4 output channels (8w x 4)

    @property
    def num_image_tokens(self) -> int:
        return self.spacial_dim * self.spacial_dim + 1  # + mean token


# Dimension table for the variants the reference UI offers
# (oldapp.py:1089-1091: ViT-B/32, ViT-B/16, ViT-L/14), plus the other
# `clip.load` names — not in the reference dropdown, but oldapp.py:28
# accepts them via EVOSSEARCH_CLIP_MODEL, so capability parity requires
# the specs (ViT-L/14@336px and the RN* family below).
CLIP_MODEL_SPECS: dict[str, CLIPModelSpec | "CLIPResNetSpec"] = {
    "ViT-B/32": CLIPModelSpec(
        name="ViT-B/32",
        image_size=224, patch_size=32,
        vision_width=768, vision_layers=12, vision_heads=12,
        text_width=512, text_layers=12, text_heads=8,
        vocab_size=CLIP_VOCAB_SIZE, context_length=CLIP_CONTEXT_LENGTH,
        embed_dim=512,
    ),
    "ViT-B/16": CLIPModelSpec(
        name="ViT-B/16",
        image_size=224, patch_size=16,
        vision_width=768, vision_layers=12, vision_heads=12,
        text_width=512, text_layers=12, text_heads=8,
        vocab_size=CLIP_VOCAB_SIZE, context_length=CLIP_CONTEXT_LENGTH,
        embed_dim=512,
    ),
    "ViT-L/14": CLIPModelSpec(
        name="ViT-L/14",
        image_size=224, patch_size=14,
        vision_width=1024, vision_layers=24, vision_heads=16,
        text_width=768, text_layers=12, text_heads=12,
        vocab_size=CLIP_VOCAB_SIZE, context_length=CLIP_CONTEXT_LENGTH,
        embed_dim=768,
    ),
    # Same tower as ViT-L/14 at 336 px input: grid 24 -> 577 image tokens,
    # vision positional embedding is the only larger tensor.
    "ViT-L/14@336px": CLIPModelSpec(
        name="ViT-L/14@336px",
        image_size=336, patch_size=14,
        vision_width=1024, vision_layers=24, vision_heads=16,
        text_width=768, text_layers=12, text_heads=12,
        vocab_size=CLIP_VOCAB_SIZE, context_length=CLIP_CONTEXT_LENGTH,
        embed_dim=768,
    ),
    # The modified-ResNet family of the OpenAI release (dims from the
    # released checkpoints; heads = width * 32 // 64 per clip/model.py's
    # build_model). The EfficientNet-style scaled variants grow width AND
    # input resolution together.
    "RN50": CLIPResNetSpec(
        name="RN50",
        image_size=224, vision_width=64, vision_layers=(3, 4, 6, 3),
        vision_heads=32,
        text_width=512, text_layers=12, text_heads=8,
        vocab_size=CLIP_VOCAB_SIZE, context_length=CLIP_CONTEXT_LENGTH,
        embed_dim=1024,
    ),
    "RN101": CLIPResNetSpec(
        name="RN101",
        image_size=224, vision_width=64, vision_layers=(3, 4, 23, 3),
        vision_heads=32,
        text_width=512, text_layers=12, text_heads=8,
        vocab_size=CLIP_VOCAB_SIZE, context_length=CLIP_CONTEXT_LENGTH,
        embed_dim=512,
    ),
    "RN50x4": CLIPResNetSpec(
        name="RN50x4",
        image_size=288, vision_width=80, vision_layers=(4, 6, 10, 6),
        vision_heads=40,
        text_width=640, text_layers=12, text_heads=10,
        vocab_size=CLIP_VOCAB_SIZE, context_length=CLIP_CONTEXT_LENGTH,
        embed_dim=640,
    ),
    "RN50x16": CLIPResNetSpec(
        name="RN50x16",
        image_size=384, vision_width=96, vision_layers=(6, 8, 18, 8),
        vision_heads=48,
        text_width=768, text_layers=12, text_heads=12,
        vocab_size=CLIP_VOCAB_SIZE, context_length=CLIP_CONTEXT_LENGTH,
        embed_dim=768,
    ),
    "RN50x64": CLIPResNetSpec(
        name="RN50x64",
        image_size=448, vision_width=128, vision_layers=(3, 15, 36, 10),
        vision_heads=64,
        text_width=1024, text_layers=12, text_heads=16,
        vocab_size=CLIP_VOCAB_SIZE, context_length=CLIP_CONTEXT_LENGTH,
        embed_dim=1024,
    ),
}
