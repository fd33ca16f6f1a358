"""CLIP image + text towers — PyTorch counterpart of
``evossearch_tpu/models/clip.py``, numerically faithful to the same
OpenAI architecture.

  image: (B, S, S, 3) preprocessed -> patchify-matmul (bias-free, flatten
         order (ph, pw, c)) -> +class token -> +pos embed -> ln_pre ->
         pre-LN blocks -> ln_post(CLS) -> proj
  text:  (B, ctx) token ids -> token+pos embed -> causal pre-LN blocks ->
         ln_final -> pooled at EOT (argmax of ids) -> text_projection

Images stay channels-last (B, H, W, 3) at the public functions, as in the
JAX package. A ``CLIPResNetSpec`` takes the modified-ResNet image tower
(``models/resnet.py``) beside the same text tower; ``encode_image``
dispatches through the module the spec built.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..core.constants import CLIPModelSpec
from ..core.device import resolve_device
from .layers import (
    LayerNorm,
    TowerConfig,
    init_tower_,
    matmul_f32,
    run_blocks,
    transformer,
)
from .resnet import ModifiedResNet, expected_visual_param_count, init_visual_resnet


def _patch_embed(images: torch.Tensor, kernel: torch.Tensor, patch: int):
    """(B, H, W, C) -> (B, gh*gw, width): patches flattened (ph, pw, c)
    against a (patch*patch*C, width) kernel, float32 result."""
    b, h, w, c = images.shape
    gh, gw = h // patch, w // patch
    x = images.reshape(b, gh, patch, gw, patch, c).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(b, gh * gw, patch * patch * c)
    return matmul_f32(x, kernel.to(images.dtype))


class VisionTower(nn.Module):
    def __init__(self, spec: CLIPModelSpec):
        super().__init__()
        vw = spec.vision_width
        self.spec = spec
        self.cfg = TowerConfig(vw, spec.vision_layers, spec.vision_heads)
        self.patch_embed = nn.ParameterDict({
            "kernel": nn.Parameter(torch.empty(spec.patch_size ** 2 * 3, vw))
        })
        self.class_embedding = nn.Parameter(torch.empty(vw))
        self.pos_embed = nn.Parameter(torch.empty(spec.num_image_tokens, vw))
        self.ln_pre = LayerNorm(vw)
        self.blocks = transformer(self.cfg)
        self.ln_post = LayerNorm(vw)
        self.proj = nn.Parameter(torch.empty(vw, spec.embed_dim))

    def forward(self, images: torch.Tensor, dtype: torch.dtype,
                remat: bool = False) -> torch.Tensor:
        spec = self.spec
        x = _patch_embed(
            images.to(dtype), self.patch_embed["kernel"], spec.patch_size
        ).to(dtype)
        cls = self.class_embedding.to(dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(dtype)
        x = run_blocks(self.blocks, self.ln_pre(x), remat)
        pooled = self.ln_post(x[:, 0, :]).float()
        return pooled @ self.proj.float()


class TextTower(nn.Module):
    def __init__(self, spec: CLIPModelSpec):
        super().__init__()
        tw = spec.text_width
        self.cfg = TowerConfig(tw, spec.text_layers, spec.text_heads, causal=True)
        self.token_embed = nn.Parameter(torch.empty(spec.vocab_size, tw))
        self.pos_embed = nn.Parameter(torch.empty(spec.context_length, tw))
        self.blocks = transformer(self.cfg)
        self.ln_final = LayerNorm(tw)
        self.proj = nn.Parameter(torch.empty(tw, spec.embed_dim))

    def forward(self, tokens: torch.Tensor, dtype: torch.dtype,
                remat: bool = False) -> torch.Tensor:
        x = self.token_embed[tokens].to(dtype) + self.pos_embed.to(dtype)
        x = self.ln_final(run_blocks(self.blocks, x, remat)).float()
        # EOT has the highest id in the vocab: argmax finds its position
        eot = tokens.argmax(dim=-1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eot]
        return pooled @ self.proj.float()


class CLIP(nn.Module):
    """Both towers; parameter names follow the JAX pytree with per-layer
    block modules (``visual.blocks.3.attn.wqkv`` is layer 3 of the JAX
    leaf ``visual/blocks/attn/wqkv``; ``visual.stage3.rest.0.conv1.kernel``
    is block 0 of the stacked leaf ``visual/stage3/rest/conv1/kernel``)."""

    def __init__(self, spec: CLIPModelSpec):
        super().__init__()
        self.spec = spec
        self.visual = (
            ModifiedResNet(spec) if spec.family == "resnet" else VisionTower(spec)
        )
        self.text = TextTower(spec)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))

    def init_random_(self, gen: torch.Generator) -> "CLIP":
        """OpenAI init scheme from ``gen``, in place. The numbers differ
        from the JAX package's ``init_params(jax.random.key(0))``."""
        spec, v, t = self.spec, self.visual, self.text
        vw, tw = spec.vision_width, spec.text_width
        with torch.no_grad():
            if spec.family == "resnet":
                init_visual_resnet(v, gen)
            else:
                v.patch_embed["kernel"].normal_(0.0, vw ** -0.5, generator=gen)
                v.class_embedding.normal_(0.0, vw ** -0.5, generator=gen)
                v.pos_embed.normal_(0.0, vw ** -0.5, generator=gen)
                v.proj.normal_(0.0, vw ** -0.5, generator=gen)
                init_tower_(v.blocks, v.cfg, gen)
            t.token_embed.normal_(0.0, 0.02, generator=gen)
            t.pos_embed.normal_(0.0, 0.01, generator=gen)
            t.proj.normal_(0.0, tw ** -0.5, generator=gen)
            init_tower_(t.blocks, t.cfg, gen)
        return self


def init_params(spec: CLIPModelSpec, seed: int = 0,
                device: str | torch.device | None = None) -> CLIP:
    """A random-init :class:`CLIP` (OpenAI init scheme) from a torch
    generator seeded with ``seed``, on ``device`` (None: the GPU, or a
    raise without one). Its numbers differ from the JAX package's
    ``init_params(jax.random.key(seed), spec)``."""
    device = resolve_device(device)
    return CLIP(spec).init_random_(torch.Generator().manual_seed(seed)).to(device)


def count_params(model: CLIP) -> int:
    """Elements over every parameter (the JAX package's leaf sizes)."""
    return sum(p.numel() for p in model.parameters())


def expected_param_count(spec: CLIPModelSpec) -> int:
    """Analytic parameter count of a spec, the JAX package's: ViT-B/32 ==
    151,277,313 and ViT-B/16 == 149,620,737 (the OpenAI release counts);
    ResNet specs count their BN statistics, which are parameters here."""

    def tower(width: int, layers: int) -> int:
        attn = width * 3 * width + 3 * width + width * width + width
        mlp = width * 4 * width + 4 * width + 4 * width * width + width
        lns = 2 * (2 * width)
        return layers * (attn + mlp + lns)

    vw, tw = spec.vision_width, spec.text_width
    if spec.family == "resnet":
        visual = expected_visual_param_count(spec)
    else:
        visual = (
            spec.patch_size * spec.patch_size * 3 * vw  # patch embed (no bias)
            + vw  # class embedding
            + spec.num_image_tokens * vw  # pos embed
            + 2 * vw + 2 * vw  # ln_pre + ln_post
            + tower(vw, spec.vision_layers)
            + vw * spec.embed_dim  # projection
        )
    text = (
        spec.vocab_size * tw
        + spec.context_length * tw
        + 2 * tw  # ln_final
        + tower(tw, spec.text_layers)
        + tw * spec.embed_dim
    )
    return visual + text + 1  # + logit_scale


def _l2_normalize(emb: torch.Tensor) -> torch.Tensor:
    return emb / torch.linalg.norm(emb, dim=-1, keepdim=True)


def embed_image(model: CLIP, images: torch.Tensor,
                compute_dtype: torch.dtype = torch.float32,
                remat: bool = False) -> torch.Tensor:
    """The image tower with autograd, for the training loss (ViT family):
    (B, S, S, 3) preprocessed -> (B, embed_dim) float32, L2-normalized.
    ``remat`` recomputes each block in the backward pass."""
    return _l2_normalize(model.visual(images, compute_dtype, remat))


def embed_text(model: CLIP, tokens: torch.Tensor,
               compute_dtype: torch.dtype = torch.float32,
               remat: bool = False) -> torch.Tensor:
    """The text tower with autograd, for the training loss: (B,
    context_length) ids -> (B, embed_dim) float32, L2-normalized."""
    return _l2_normalize(model.text(tokens.long(), compute_dtype, remat))


@torch.no_grad()
def encode_image(model: CLIP, images: torch.Tensor,
                 compute_dtype: torch.dtype = torch.float32,
                 normalize: bool = True) -> torch.Tensor:
    """images: (B, S, S, 3) preprocessed. Returns (B, embed_dim) float32,
    L2-normalized by default."""
    emb = model.visual(images, compute_dtype)
    return _l2_normalize(emb) if normalize else emb


@torch.no_grad()
def encode_text(model: CLIP, tokens: torch.Tensor,
                compute_dtype: torch.dtype = torch.float32,
                normalize: bool = True) -> torch.Tensor:
    """tokens: (B, context_length) integer ids. Returns (B, embed_dim)
    float32, L2-normalized by default."""
    emb = model.text(tokens.long(), compute_dtype)
    return _l2_normalize(emb) if normalize else emb
