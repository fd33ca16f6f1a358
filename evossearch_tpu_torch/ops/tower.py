"""The CLIP towers' elementwise chains: the fused CUDA kernels
(``csrc/tower_fused.cu``) and their plain versions.

Each chain between two products of ``models/layers.py`` is one call here:

``bias_cast`` (a dense layer's epilogue): ``bf16(y + b)`` of a float32
  GEMM output and a float32 bias; bit-equal to the plain version.
``bias_gelu_cast`` (the MLP's first product): quick-GELU of that value,
  rounded to bf16 after each op as the plain version rounds it; bit-equal.
``layer_norm``: float32 LayerNorm of a bf16 row, cast back, its mean and
  variance summed in torch's reduction order; within one bf16 ulp of the
  plain version.
``softmax_cast`` (attention): ``logits * scale``, the causal mask, the
  float32 softmax and the cast of the weights; the plain version's per-row
  order (torch's warp softmax), within one bf16 ulp.

The plain versions (``*_plain``) are the towers' torch code, unchanged.
Each wrapper takes the route of ``ops/fused.py``; on the kernel's it
checks dtype, shape, contiguity and 16-byte alignment and raises on what
the kernel does not take (no ``try`` falls back). Each launch counts under
``tower_fused_launches``, each CUDA call on the plain route under
``tower_plain_cuda_calls``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import fused

LN_EPS = 1e-5  # OpenAI/HF CLIP LayerNorm epsilon
FUSED = "tower_fused_launches"
PLAIN_CUDA = "tower_plain_cuda_calls"
_MAX_LN_WIDTH = 2048  # csrc/tower_fused.cu: 16 vectors of 4 values a lane
_MAX_SOFTMAX_LEN = 1024  # csrc/tower_fused.cu: 32 elements a lane


# -- plain versions -----------------------------------------------------------


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def bias_cast_plain(y: torch.Tensor, bias: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return (y + bias.float()).to(dtype)


def bias_gelu_cast_plain(y: torch.Tensor, bias: torch.Tensor,
                         dtype: torch.dtype) -> torch.Tensor:
    return quick_gelu(bias_cast_plain(y, bias, dtype))


def layer_norm_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last dim in float32, cast back to ``x``'s dtype."""
    dtype = x.dtype
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + LN_EPS)
    return (y * scale.float() + bias.float()).to(dtype)


def softmax_cast_plain(logits: torch.Tensor, scale: float, causal: bool,
                       dtype: torch.dtype) -> torch.Tensor:
    """Softmax over the last dim of float32 (..., T, T) ``logits * scale``,
    keys after the query masked when ``causal``, cast to ``dtype``."""
    logits = logits * scale
    if causal:
        t = logits.shape[-1]
        keep = torch.ones(t, t, dtype=torch.bool, device=logits.device).tril()
        logits = logits.masked_fill(~keep, torch.finfo(torch.float32).min)
    return torch.softmax(logits, dim=-1).to(dtype)


# -- wrappers -----------------------------------------------------------------


def _bias_call(name: str, y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    fused.check(y, "GEMM output", torch.float32)
    n = y.shape[-1]
    bias = bias.float()
    if bias.shape != (n,):
        raise ValueError(f"bias shape {tuple(bias.shape)} does not match width {n}")
    fused.check(bias, "bias", torch.float32)
    if n % 8:
        raise ValueError(f"width {n} must be a multiple of 8")
    out = torch.empty(y.shape, dtype=torch.bfloat16, device=y.device)
    fused.launch(name, y.device, [y, bias, out, y.numel() // max(n, 1), n], FUSED)
    return out


def bias_cast(y: torch.Tensor, bias: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``bf16(y + bias)`` of a float32 GEMM output (..., N) and a bias (N)
    for compute dtype ``dtype`` (see ``bias_cast_plain``)."""
    if not fused.use_kernel(y, dtype, bias, plain=PLAIN_CUDA):
        return bias_cast_plain(y, bias, dtype)
    return _bias_call("bias_cast", y, bias)


def bias_gelu_cast(y: torch.Tensor, bias: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``quick_gelu(bias_cast(y, bias, dtype))`` (see
    ``bias_gelu_cast_plain``)."""
    if not fused.use_kernel(y, dtype, bias, plain=PLAIN_CUDA):
        return bias_gelu_cast_plain(y, bias, dtype)
    return _bias_call("bias_gelu_cast", y, bias)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """LayerNorm of ``x`` over its last dim (see ``layer_norm_plain``)."""
    if not fused.use_kernel(x, x.dtype, scale, bias, plain=PLAIN_CUDA):
        return layer_norm_plain(x, scale, bias)
    fused.check(x, "LayerNorm input", torch.bfloat16)
    w = x.shape[-1]
    scale, bias = scale.float(), bias.float()
    for p, what in ((scale, "LayerNorm scale"), (bias, "LayerNorm bias")):
        if p.shape != (w,):
            raise ValueError(f"{what} shape {tuple(p.shape)} does not match width {w}")
        fused.check(p, what, torch.float32)
    if w % 4 or w > _MAX_LN_WIDTH:
        raise ValueError(f"width {w} must be a multiple of 4 up to {_MAX_LN_WIDTH}")
    rows = x.numel() // w
    out = torch.empty_like(x)
    fused.launch("layer_norm", x.device,
                 [x, scale, bias, out, rows, w, _mean_factor(rows, w), LN_EPS], FUSED)
    return out


@functools.lru_cache(maxsize=256)
def _mean_factor(rows: int, w: int) -> float:
    """torch's factor of a mean over ``w`` of ``rows * w`` values: the sum
    times fl(rows / (rows * w)), computed in float32."""
    return float(np.float32(rows) / np.float32(rows * w)) if rows else 0.0


def softmax_cast(logits: torch.Tensor, scale: float, causal: bool,
                 dtype: torch.dtype) -> torch.Tensor:
    """Attention weights in ``dtype`` from float32 (..., T, T) logits
    (see ``softmax_cast_plain``)."""
    if not fused.use_kernel(logits, dtype, plain=PLAIN_CUDA):
        return softmax_cast_plain(logits, scale, causal, dtype)
    fused.check(logits, "logits", torch.float32)
    t = logits.shape[-1]
    if logits.dim() < 2 or logits.shape[-2] != t or t > _MAX_SOFTMAX_LEN:
        raise ValueError(f"logits {tuple(logits.shape)} must be (..., T, T), "
                         f"T <= {_MAX_SOFTMAX_LEN}")
    out = torch.empty(logits.shape, dtype=torch.bfloat16, device=logits.device)
    fused.launch("softmax_cast", logits.device,
                 [logits, out, logits.numel() // t, t, scale, int(causal)], FUSED)
    return out
