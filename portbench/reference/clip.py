"""CLIP's two towers, written plainly from the published architecture
(Radford et al. 2021, arXiv:2103.00020; ``github.com/openai/CLIP``,
``clip/model.py``: ``VisionTransformer``, ``Transformer``,
``ResidualAttentionBlock``, ``encode_text``).

  image: patches (conv1 as a product over patches flattened (ph, pw, c))
         -> + class token -> + positions -> ln_pre -> pre-LN blocks ->
         ln_post of the class token -> projection
  text:  token + position embeddings -> causal pre-LN blocks -> ln_final
         -> the row at the end-of-text token (the highest id) ->
         projection
  block: x + attn(ln_1(x)); x + mlp(ln_2(x)); quick-GELU x*sigmoid(1.702x);
         LayerNorm eps 1e-5; one fused qkv product, heads of width/heads.

The modified-ResNet image tower of the ``resnet`` family is ``resnet.py``.

Weights are a dict of the names ``portbench.data.weight_layout`` gives
(dense kernels stored (in, out)). The same seeded tensors are handed to
the program.

``precision``: ``"fp32"`` computes every product in float32 with TF32
off (the reference); ``"fp8"`` rounds both operands of every product to
float8 e4m3 with a per-tensor scale (amax / 448) and accumulates in
float32, the step below the configurations' bfloat16 (the control).
Everything else is float32 in both.
"""

from __future__ import annotations

import contextlib

import torch

LN_EPS = 1e-5
FP8_MAX = 448.0


@contextlib.contextmanager
def no_tf32():
    """float32 products at full float32 precision for the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale, back in float32."""
    scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp8":
        a, b = _fp8(a), _fp8(b)
    return torch.matmul(a, b)


def _ln(x, w, p):
    return torch.nn.functional.layer_norm(
        x, x.shape[-1:], w[p + ".scale"], w[p + ".bias"], LN_EPS)


def _block(x, w, p, heads, causal, precision):
    b, t, width = x.shape
    hd = width // heads
    h = _ln(x, w, p + "ln_1")
    qkv = _mm(h, w[p + "attn.wqkv"], precision) + w[p + "attn.bqkv"]
    q, k, v = (a.reshape(b, t, heads, hd).transpose(1, 2) for a in qkv.split(width, -1))
    logits = _mm(q, k.transpose(-1, -2), precision) * hd ** -0.5
    if causal:
        mask = torch.ones(t, t, dtype=torch.bool, device=x.device).triu(1)
        logits = logits.masked_fill(mask, float("-inf"))
    att = _mm(torch.softmax(logits, -1), v, precision)
    att = att.transpose(1, 2).reshape(b, t, width)
    x = x + _mm(att, w[p + "attn.wo"], precision) + w[p + "attn.bo"]
    h = _ln(x, w, p + "ln_2")
    h = _mm(h, w[p + "mlp.w1"], precision) + w[p + "mlp.b1"]
    h = h * torch.sigmoid(1.702 * h)
    return x + _mm(h, w[p + "mlp.w2"], precision) + w[p + "mlp.b2"]


def _normalize(e: torch.Tensor) -> torch.Tensor:
    return e / torch.linalg.norm(e, dim=-1, keepdim=True)


@torch.no_grad()
def encode_text(w: dict, tokens: torch.Tensor, model: dict, precision: str = "fp32"):
    """(B, context) ids -> (B, embed_dim) unit float32 rows."""
    with no_tf32():
        x = w["text.token_embed"][tokens] + w["text.pos_embed"]
        for i in range(model["text_layers"]):
            x = _block(x, w, f"text.blocks.{i}.", model["text_heads"], True, precision)
        x = _ln(x, w, "text.ln_final")
        pooled = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(-1)]
        return _normalize(_mm(pooled, w["text.proj"], precision))


@torch.no_grad()
def encode_image(w: dict, images: torch.Tensor, model: dict, precision: str = "fp32"):
    """(B, S, S, 3) normalized float32 pixels -> (B, embed_dim) unit rows;
    a configuration of the ``resnet`` family takes ``resnet.encode_image``."""
    if model.get("family", "vit") == "resnet":
        from . import resnet

        return resnet.encode_image(w, images, model, precision)
    with no_tf32():
        b, s, _, c = images.shape
        p = model["patch_size"]
        g = s // p
        patches = images.reshape(b, g, p, g, p, c).permute(0, 1, 3, 2, 4, 5)
        x = _mm(patches.reshape(b, g * g, p * p * c), w["visual.patch_embed.kernel"],
                precision)
        cls = w["visual.class_embedding"].expand(b, 1, -1)
        x = torch.cat([cls, x], 1) + w["visual.pos_embed"]
        x = _ln(x, w, "visual.ln_pre")
        for i in range(model["vision_layers"]):
            x = _block(x, w, f"visual.blocks.{i}.", model["vision_heads"], False, precision)
        pooled = _ln(x[:, 0], w, "visual.ln_post")
        return _normalize(_mm(pooled, w["visual.proj"], precision))
