"""The modified ResNet's conv epilogues: their plain torch ops, counted,
and the fused CUDA kernels (``csrc/rn_epilogue.cu``).

An epilogue chain is what runs on a conv's bf16 output before the next
conv reads it. ``models/resnet.py`` has five, each one call here:

``bn_relu``: ``relu(bn(x))``, the stem's BatchNorms, every block's bn1,
  and bn2 where the stride is 1; with ``stride`` 2 the 2x2 average pool
  of those values (the stem's last BatchNorm, bn2 of a stride-2 block).
``bn_add_relu``: ``relu(bn(x) + r)``, a tail block's bn3 and its input.
``bn_bn_add_relu``: ``relu(bn(x) + bn'(y))``, a down block's bn3 and its
  shortcut conv's output through the shortcut's BatchNorm.
``avg_pool``: the 2x2 average pool of a stride-2 down block's input, its
  shortcut before the conv.

``bn(x)`` is inference BatchNorm as a float32 affine ``x * scale + shift``
per channel, rounded to the input's dtype (``batch_norm_plain``); the
pools sum in float32 with floor semantics. The kernels keep every
rounding of the plain ops, so their output is the plain ops' bit for bit.

The ``*_plain`` chains are the tower's torch ops. Each public chain takes
the route of ``ops/fused.py``, the conv output's dtype its compute dtype.
On the kernel's route it checks dtype, channels-last contiguity, ``C % 8
== 0``, 16-byte alignment, the per-channel vectors and the pool's stride,
and raises on what the kernel does not take (no ``try`` falls back). The
plain route keeps the tower's ops, their order and their temporaries'
lifetimes: a chain frees the BatchNorm vectors and a conv output handed
over to it (passed and kept by no caller) after that BatchNorm, and
``bn_bn_add_relu`` runs its shortcut after ``bn(x)`` there and before the
launch on the kernel's route.

Counts, while a thread is inside ``fused.counting(counters)``: each plain
pass on a CUDA tensor adds 1 to ``rn_epilogue_passes`` and the bytes it
reads and writes (every operand and the output, from their element counts
and dtypes) to ``rn_epilogue_bytes``; each launch adds 1 to both
``rn_epilogue_passes`` and ``rn_epilogue_fused_launches`` and the bytes
the kernel reads and writes (its inputs, the residual, its output, and 8
bytes a channel of each BatchNorm's scale and shift) to
``rn_epilogue_bytes``; each chain on a CUDA tensor that took the plain
ops adds 1 to ``rn_epilogue_plain_cuda_calls``. Nothing synchronises.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from . import fused

PASSES = "rn_epilogue_passes"
BYTES = "rn_epilogue_bytes"
FUSED = "rn_epilogue_fused_launches"
PLAIN_CUDA = "rn_epilogue_plain_cuda_calls"
BF16 = torch.bfloat16


# -- plain versions -------------------------------------------------------------


def count_pass(out: torch.Tensor, *inputs: torch.Tensor) -> torch.Tensor:
    """Counts one plain pass that read ``inputs`` and wrote ``out`` (see
    the module's docstring); returns ``out``."""
    if fused.on_card(out):
        fused.count(PASSES)
        fused.count(BYTES, sum(t.numel() * t.element_size() for t in (out, *inputs)))
    return out


def cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x.to(dtype)``, counted where it is a pass (the dtype differs)."""
    out = x.to(dtype)
    return out if out is x else count_pass(out, x)


def batch_norm_plain(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """``x * scale + shift`` in float32 per channel of (N, C, H, W) ``x``,
    in ``x``'s dtype."""
    scale, shift = scale[:, None, None], shift[:, None, None]
    xf = cast(x, torch.float32)
    y = count_pass(xf * scale, xf, scale)
    del xf  # freed before the add, as the one-expression form frees it: same peak memory
    y = count_pass(y + shift, y, shift)
    return cast(y, x.dtype)


def relu_plain(x: torch.Tensor) -> torch.Tensor:
    return count_pass(torch.relu(x), x)


def add_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return count_pass(a + b, a, b)


def avg_pool_plain(x: torch.Tensor, stride: int) -> torch.Tensor:
    """AvgPool2d(stride): kernel == stride, no padding, floor semantics;
    summed in f32."""
    if stride == 1:
        return x
    xf = cast(x, torch.float32)
    y = count_pass(F.avg_pool2d(xf, stride), xf)
    del xf
    return cast(y, x.dtype)


def bn_relu_plain(x, scale, shift, stride: int = 1) -> torch.Tensor:
    return avg_pool_plain(relu_plain(batch_norm_plain(x, scale, shift)), stride)


def bn_add_relu_plain(x, scale, shift, r) -> torch.Tensor:
    return relu_plain(add_plain(batch_norm_plain(x, scale, shift), r))


def bn_bn_add_relu_plain(x, scale, shift, y, scale2, shift2) -> torch.Tensor:
    out = batch_norm_plain(x, scale, shift)
    return relu_plain(add_plain(out, batch_norm_plain(y, scale2, shift2)))


# -- the chains -------------------------------------------------------------------


def _check_activation(t: torch.Tensor, what: str) -> None:
    if t.dtype != BF16:
        raise ValueError(f"{what} must be {BF16}, got {t.dtype}")
    if t.dim() != 4 or not t.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{what} must be a channels-last contiguous (N, C, H, W) tensor")
    if t.shape[1] % 8:
        raise ValueError(f"{what}'s channels ({t.shape[1]}) must be a multiple of 8")
    if t.data_ptr() % 16:
        raise ValueError(f"{what} must be 16-byte aligned")


def _check_affine(scale: torch.Tensor, shift: torch.Tensor, c: int) -> None:
    for p, what in ((scale, "BatchNorm scale"), (shift, "BatchNorm shift")):
        if p.shape != (c,):
            raise ValueError(f"{what} shape {tuple(p.shape)} does not match {c} channels")
        fused.check(p, what, torch.float32)


def _check_stride(stride: int) -> None:
    if stride not in (1, 2):
        raise ValueError(f"pool stride {stride}: the kernels pool 2x2 windows only")


def _launch(name: str, x: torch.Tensor, args: list, nbytes: int) -> None:
    fused.launch(name, x.device, args, FUSED)
    fused.count(PASSES)
    fused.count(BYTES, nbytes)


def _pooled(x: torch.Tensor) -> torch.Tensor:
    n, c, h, w = x.shape
    return torch.empty((n, c, h // 2, w // 2), dtype=BF16, device=x.device,
                       memory_format=torch.channels_last)


def bn_relu(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
            stride: int = 1) -> torch.Tensor:
    """``bn_relu_plain``: one launch on the kernel's route (``stride`` 1
    or 2)."""
    if not fused.use_kernel(x, x.dtype, scale, shift, plain=PLAIN_CUDA):
        y = batch_norm_plain(x, scale, shift)
        del scale, shift  # freed here if handed over (see the module's docstring)
        y = relu_plain(y)
        return avg_pool_plain(y, stride)
    _check_activation(x, "conv output")
    _check_stride(stride)
    n, c, h, w = x.shape
    _check_affine(scale, shift, c)
    if stride == 1:
        out = torch.empty_like(x, memory_format=torch.channels_last)
        _launch("rn_bn_relu", x, [x, scale, shift, out, n * h * w, c],
                4 * x.numel() + 8 * c)
        return out
    out = _pooled(x)
    _launch("rn_bn_relu_pool", x, [x, scale, shift, out, n, h, w, c],
            10 * out.numel() + 8 * c)  # each output reads its 2x2 window
    return out


def bn_add_relu(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                r: torch.Tensor) -> torch.Tensor:
    """``bn_add_relu_plain``: one launch on the kernel's route."""
    if not fused.use_kernel(x, x.dtype, scale, shift, r, plain=PLAIN_CUDA):
        out = batch_norm_plain(x, scale, shift)
        del x, scale, shift  # freed here if handed over
        return relu_plain(add_plain(out, r))
    _check_activation(x, "conv output")
    _check_activation(r, "residual")
    if r.shape != x.shape:
        raise ValueError(f"residual {tuple(r.shape)} does not match {tuple(x.shape)}")
    n, c, h, w = x.shape
    _check_affine(scale, shift, c)
    out = torch.empty_like(x, memory_format=torch.channels_last)
    _launch("rn_bn_add_relu", x, [x, scale, shift, r, out, n * h * w, c],
            6 * x.numel() + 8 * c)
    return out


def bn_bn_add_relu(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                   shortcut: Callable[[], tuple]) -> torch.Tensor:
    """``bn_bn_add_relu_plain`` of ``x`` and ``shortcut()``, which returns
    the shortcut conv's output and its BatchNorm's (scale, shift): one
    launch on the kernel's route, which runs the shortcut first; the plain
    route runs it after ``bn(x)``. The shortcut's operands take the route
    that ``x`` and its BatchNorm take."""
    if not fused.use_kernel(x, x.dtype, scale, shift, plain=PLAIN_CUDA):
        out = batch_norm_plain(x, scale, shift)
        del x, scale, shift  # freed here if handed over
        y = batch_norm_plain(*shortcut())
        return relu_plain(add_plain(out, y))
    y, scale2, shift2 = shortcut()
    _check_activation(x, "conv output")
    _check_activation(y, "shortcut conv output")
    if y.shape != x.shape:
        raise ValueError(f"shortcut {tuple(y.shape)} does not match {tuple(x.shape)}")
    n, c, h, w = x.shape
    _check_affine(scale, shift, c)
    _check_affine(scale2, shift2, c)
    out = torch.empty_like(x, memory_format=torch.channels_last)
    _launch("rn_bn_bn_add_relu", x, [x, scale, shift, y, scale2, shift2, out, n * h * w, c],
            6 * x.numel() + 16 * c)
    return out


def avg_pool(x: torch.Tensor, stride: int) -> torch.Tensor:
    """``avg_pool_plain``: one launch on the kernel's route (``stride`` 1
    returns ``x``, and is no chain)."""
    if stride == 1:
        return x
    if not fused.use_kernel(x, x.dtype, plain=PLAIN_CUDA):
        return avg_pool_plain(x, stride)
    _check_stride(stride)
    _check_activation(x, "pool input")
    n, c, h, w = x.shape
    out = _pooled(x)
    _launch("rn_avg_pool", x, [x, out, n, h, w, c], 10 * out.numel())
    return out
