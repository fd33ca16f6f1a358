"""Transformer building blocks for the CLIP towers — PyTorch modules.

Counterpart of ``evossearch_tpu/models/layers.py``, with the same numerics:
  * parameters are float32 and laid out as the JAX pytree's leaves (dense
    kernels ``(in, out)``), one module per layer where the JAX package
    stacks layers on a leading axis;
  * products take their operands in the compute dtype (the activation's
    dtype; kernels are cast to it) and accumulate AND return float32, as
    ``preferred_element_type=float32`` does (``matmul_f32``), so no bf16
    rounding happens inside a product and a dense layer's bias is added
    in float32 before the one cast back to the compute dtype;
  * LayerNorm runs in float32; attention logits and softmax in float32;
  * CLIP uses quick-GELU (``x * sigmoid(1.702 x)``), not tanh-GELU.

float32 products never use TF32 (``torch.backends.cuda.matmul.allow_tf32``
stays False, PyTorch's default): the JAX package computes them at full
float32 precision.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

LN_EPS = 1e-5  # OpenAI/HF CLIP LayerNorm epsilon


@dataclasses.dataclass(frozen=True)
class TowerConfig:
    """Shape of one transformer tower."""

    width: int
    layers: int
    heads: int
    causal: bool = False


def _tensor_core_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 x bf16 -> float32 GEMM (``b`` (K, N) or batched like ``a``)."""
    out_shape = (*a.shape[:-1], b.shape[-1])
    if b.dim() == 2:
        out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
    else:
        out = torch.bmm(a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:]),
                        out_dtype=torch.float32)
    return out.reshape(out_shape)


class MatmulF32(torch.autograd.Function):
    """The bf16 tensor-core product with the gradient of the widened one:
    each operand's cotangent is the float32 product of the float32
    cotangent with the other operand widened, cast to the operand's dtype
    (what autograd gives the CPU route, and what JAX's transpose of a dot
    with ``preferred_element_type=float32`` returns). The forward runs
    ``_tensor_core_mm`` on a GPU and the widened product elsewhere."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.device.type == "cuda":
            return _tensor_core_mm(a, b)
        return torch.matmul(a.float(), b.float())

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.float()
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.matmul(g, b.float().transpose(-1, -2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            af = a.float()
            if b.dim() == 2:  # (..., K) x (K, N): sum over every leading dim
                af, g = af.reshape(-1, af.shape[-1]), g.reshape(-1, g.shape[-1])
            gb = torch.matmul(af.transpose(-1, -2), g).to(b.dtype)
        return ga, gb


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 product of operands given in the compute dtype: float32
    accumulation and result. On a GPU, bf16 operands go to the tensor
    cores as a bf16 x bf16 -> float32 GEMM (bf16 products are exact in
    float32, so this is the widened product in another summation order)
    through ``MatmulF32``, whose backward is the widened product's;
    elsewhere they are widened exactly first. ``b`` is (K, N) or batched
    like ``a``."""
    if a.dtype != torch.bfloat16 or a.device.type != "cuda":
        return torch.matmul(a.float(), b.float())
    return MatmulF32.apply(a, b)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def _dense(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor | None):
    y = matmul_f32(x, kernel.to(x.dtype))
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last dim in float32, cast back to ``x``'s dtype."""
    dtype = x.dtype
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + LN_EPS)
    return (y * scale.float() + bias.float()).to(dtype)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> torch.Tensor:
    """Scaled dot-product attention of (B, H, T, hd) heads in the compute
    dtype: float32 logits and softmax, output in the compute dtype."""
    t, hd = q.shape[-2], q.shape[-1]
    logits = matmul_f32(q, k.transpose(-1, -2)) * (hd ** -0.5)
    if causal:
        keep = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, torch.finfo(torch.float32).min)
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return matmul_f32(weights, v).to(q.dtype)


class LayerNorm(nn.Module):
    """LayerNorm in float32 regardless of the compute dtype."""

    def __init__(self, width: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(width))
        self.bias = nn.Parameter(torch.zeros(width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.scale, self.bias)


class Attention(nn.Module):
    """Multi-head self-attention with one fused (W, 3W) qkv projection."""

    def __init__(self, width: int, heads: int, causal: bool):
        super().__init__()
        self.heads = heads
        self.causal = causal
        self.wqkv = nn.Parameter(torch.empty(width, 3 * width))
        self.bqkv = nn.Parameter(torch.zeros(3 * width))
        self.wo = nn.Parameter(torch.empty(width, width))
        self.bo = nn.Parameter(torch.zeros(width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, w = x.shape
        hd = w // self.heads
        qkv = _dense(x, self.wqkv, self.bqkv)
        q, k, v = (
            a.reshape(b, t, self.heads, hd).transpose(1, 2)
            for a in qkv.split(w, dim=-1)
        )  # (B, H, T, hd)
        out = attend(q, k, v, self.causal).transpose(1, 2).reshape(b, t, w)
        return _dense(out, self.wo, self.bo)


class MLP(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.w1 = nn.Parameter(torch.empty(width, 4 * width))
        self.b1 = nn.Parameter(torch.zeros(4 * width))
        self.w2 = nn.Parameter(torch.empty(4 * width, width))
        self.b2 = nn.Parameter(torch.zeros(width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _dense(quick_gelu(_dense(x, self.w1, self.b1)), self.w2, self.b2)


class Block(nn.Module):
    """Pre-LN residual transformer block (OpenAI CLIP ordering)."""

    def __init__(self, cfg: TowerConfig):
        super().__init__()
        self.ln_1 = LayerNorm(cfg.width)
        self.attn = Attention(cfg.width, cfg.heads, cfg.causal)
        self.ln_2 = LayerNorm(cfg.width)
        self.mlp = MLP(cfg.width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


def transformer(cfg: TowerConfig) -> nn.ModuleList:
    return nn.ModuleList(Block(cfg) for _ in range(cfg.layers))


def run_blocks(blocks: nn.ModuleList, x: torch.Tensor, remat: bool) -> torch.Tensor:
    """The tower's blocks in order; ``remat`` recomputes each block's
    activations in the backward pass instead of keeping them
    (``torch.utils.checkpoint``, the counterpart of the JAX package's
    ``jax.checkpoint`` around each block)."""
    for blk in blocks:
        if remat and torch.is_grad_enabled():
            x = checkpoint(blk, x, use_reentrant=False)
        else:
            x = blk(x)
    return x


def init_tower_(blocks: nn.ModuleList, cfg: TowerConfig, gen: torch.Generator):
    """OpenAI CLIP's init scheme, in place (converted or saved checkpoints
    overwrite it)."""
    w, n = cfg.width, cfg.layers
    proj_std = (w ** -0.5) * ((2 * n) ** -0.5)
    attn_std = w ** -0.5
    fc_std = (2 * w) ** -0.5
    with torch.no_grad():
        for blk in blocks:
            blk.attn.wqkv.normal_(0.0, attn_std, generator=gen)
            blk.attn.wo.normal_(0.0, proj_std, generator=gen)
            blk.mlp.w1.normal_(0.0, fc_std, generator=gen)
            blk.mlp.w2.normal_(0.0, proj_std, generator=gen)
