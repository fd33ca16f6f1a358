"""CLIP image + text towers — PyTorch counterpart of
``evossearch_tpu/models/clip.py``, numerically faithful to the same
OpenAI architecture.

  image: (B, S, S, 3) preprocessed -> patchify-matmul (bias-free, flatten
         order (ph, pw, c)) -> +class token -> +pos embed -> ln_pre ->
         pre-LN blocks -> ln_post(CLS) -> proj
  text:  (B, ctx) token ids -> token+pos embed -> causal pre-LN blocks ->
         ln_final -> pooled at EOT (argmax of ids) -> text_projection

Images stay channels-last (B, H, W, 3) at the public functions, as in the
JAX package. Only the ViT family is ported.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..core.constants import CLIPModelSpec
from .layers import LayerNorm, TowerConfig, init_tower_, matmul_f32, transformer


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

    def forward(self, images: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        spec = self.spec
        x = _patch_embed(
            images.to(dtype), self.patch_embed["kernel"], spec.patch_size
        ).to(dtype)
        cls = self.class_embedding.to(dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(dtype)
        x = self.ln_pre(x)
        for blk in self.blocks:
            x = blk(x)
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

    def forward(self, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = self.token_embed[tokens].to(dtype) + self.pos_embed.to(dtype)
        for blk in self.blocks:
            x = blk(x)
        x = self.ln_final(x).float()
        # EOT has the highest id in the vocab: argmax finds its position
        eot = tokens.argmax(dim=-1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eot]
        return pooled @ self.proj.float()


class CLIP(nn.Module):
    """Both towers; parameter names follow the JAX pytree with per-layer
    block modules (``visual.blocks.3.attn.wqkv`` is layer 3 of the JAX
    leaf ``visual/blocks/attn/wqkv``)."""

    def __init__(self, spec: CLIPModelSpec):
        super().__init__()
        if spec.family != "vit":
            raise NotImplementedError(
                f"{spec.name}: only ViT CLIP towers are ported "
                "(ROADMAP A14, the ResNet family)"
            )
        self.spec = spec
        self.visual = VisionTower(spec)
        self.text = TextTower(spec)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))

    def init_random_(self, gen: torch.Generator) -> "CLIP":
        """OpenAI init scheme from ``gen``, in place. The numbers differ
        from the JAX package's ``init_params(jax.random.key(0))``."""
        spec, v, t = self.spec, self.visual, self.text
        vw, tw = spec.vision_width, spec.text_width
        with torch.no_grad():
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


def _l2_normalize(emb: torch.Tensor) -> torch.Tensor:
    return emb / torch.linalg.norm(emb, dim=-1, keepdim=True)


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
