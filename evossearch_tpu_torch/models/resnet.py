"""CLIP modified-ResNet image tower — PyTorch counterpart of
``evossearch_tpu/models/resnet.py``, the OpenAI architecture:

  * a stem of three 3x3 convs (stride 2, 1, 1), each followed by BN and
    ReLU, then a 2x2 average pool;
  * Bottleneck blocks (expansion 4) whose stride lands as an average pool
    before a stride-1 conv, in the residual branch (after conv2) AND in
    the shortcut (before its 1x1 conv);
  * an attention pool in place of global average pooling: the query is
    the mean token, attended over [mean; positions] with a learned
    positional embedding and separate q/k/v/c projections.

Numerics follow the JAX package: convs take their operands in the compute
dtype and accumulate in float32 with one rounding to the compute dtype
(cuDNN and the CPU's convs do so for bf16); inference BatchNorm is an f32
affine on the conv's output, never folded into the conv weights (folding
would round w * scale to the compute dtype); average pools sum in f32 with
floor semantics; the attention pool runs in f32. f32 convs run at full f32
precision on the card: cuDNN's TF32 is switched off around the f32
forward (``full_f32_convs``) without changing it for the process.

Parameters are float32 and named as the JAX pytree's leaves (conv
kernels HWIO ``(kh, kw, in, out)``; BN ``scale``/``bias``/``mean``/
``var``). Each stage is a ``down`` block plus a ``rest`` list of blocks,
where the JAX package stacks ``rest`` on a leading axis. Images arrive
channels-last (B, H, W, 3) and are permuted once to an NCHW view, which
keeps them channels-last in memory.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F
from torch import nn

from ..core.constants import CLIPResNetSpec

BN_EPS = 1e-5  # torch BatchNorm2d default, used by the OpenAI release

_TF32_LOCK = threading.Lock()
_TF32_STATE = {"depth": 0, "saved": True}


@contextlib.contextmanager
def full_f32_convs():
    """cuDNN's TF32 off while any thread is inside; restored after the
    last one leaves."""
    cudnn = torch.backends.cudnn
    with _TF32_LOCK:
        if _TF32_STATE["depth"] == 0:
            _TF32_STATE["saved"] = cudnn.allow_tf32
            cudnn.allow_tf32 = False
        _TF32_STATE["depth"] += 1
    try:
        yield
    finally:
        with _TF32_LOCK:
            _TF32_STATE["depth"] -= 1
            if _TF32_STATE["depth"] == 0:
                cudnn.allow_tf32 = _TF32_STATE["saved"]


class Conv(nn.Module):
    """Bias-free conv with an HWIO kernel; f32 accumulation, the result
    rounded once to the input's dtype."""

    def __init__(self, kh: int, kw: int, cin: int, cout: int,
                 stride: int = 1, padding: int = 0):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(kh, kw, cin, cout))
        self.stride, self.padding = stride, padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.kernel.permute(3, 2, 0, 1).to(x.dtype)
        return F.conv2d(x, w.contiguous(memory_format=torch.channels_last),
                        stride=self.stride, padding=self.padding)


class BatchNorm(nn.Module):
    """Inference BatchNorm as an f32 affine: (x - mean) * rsqrt(var + eps)
    * scale + bias, per channel, the result in the input's dtype."""

    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.mean = nn.Parameter(torch.zeros(c))
        self.var = nn.Parameter(torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.scale.float() * torch.rsqrt(self.var.float() + BN_EPS)
        bias = self.bias.float() - self.mean.float() * scale
        y = x.float() * scale[:, None, None] + bias[:, None, None]
        return y.to(x.dtype)


def _avg_pool(x: torch.Tensor, stride: int) -> torch.Tensor:
    """AvgPool2d(stride): kernel == stride, no padding, floor semantics;
    summed in f32."""
    if stride == 1:
        return x
    return F.avg_pool2d(x.float(), stride).to(x.dtype)


class Downsample(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = Conv(1, 1, cin, cout)
        self.bn = BatchNorm(cout)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> [avg pool] -> 1x1, BN after every conv, ReLU after
    bn1, bn2 and the residual add."""

    def __init__(self, cin: int, planes: int, downsample: bool):
        super().__init__()
        self.conv1 = Conv(1, 1, cin, planes)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv(3, 3, planes, planes, padding=1)
        self.bn2 = BatchNorm(planes)
        self.conv3 = Conv(1, 1, planes, planes * 4)
        self.bn3 = BatchNorm(planes * 4)
        self.downsample = Downsample(cin, planes * 4) if downsample else None

    def forward(self, x: torch.Tensor, stride: int) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(_avg_pool(out, stride)))
        if self.downsample is not None:
            ds = self.downsample
            x = ds.bn(ds.conv(_avg_pool(x, stride)))
        return torch.relu(out + x)


class Stage(nn.Module):
    """Block 0 carries the stride and the shortcut projection; the tail
    (``rest``) keeps the shape."""

    def __init__(self, cin: int, planes: int, blocks: int, stride: int):
        super().__init__()
        self.stride = stride
        self.down = Bottleneck(cin, planes, downsample=True)
        self.rest = nn.ModuleList(
            Bottleneck(planes * 4, planes, downsample=False)
            for _ in range(blocks - 1)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.down(x, self.stride)
        for blk in self.rest:
            x = blk(x, 1)
        return x


class Stem(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.conv1 = Conv(3, 3, 3, width // 2, stride=2, padding=1)
        self.bn1 = BatchNorm(width // 2)
        self.conv2 = Conv(3, 3, width // 2, width // 2, padding=1)
        self.bn2 = BatchNorm(width // 2)
        self.conv3 = Conv(3, 3, width // 2, width, padding=1)
        self.bn3 = BatchNorm(width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.bn1(self.conv1(x)))
        x = torch.relu(self.bn2(self.conv2(x)))
        x = torch.relu(self.bn3(self.conv3(x)))
        return _avg_pool(x, 2)


class AttentionPool(nn.Module):
    """(B, C, H, W) -> (B, embed_dim) in f32: one query (the mean token)
    over [mean; positions] plus a learned positional embedding."""

    def __init__(self, tokens: int, c: int, heads: int, embed_dim: int):
        super().__init__()
        self.heads = heads
        self.pos_embed = nn.Parameter(torch.empty(tokens, c))
        for name, shape in (("wq", (c, c)), ("bq", (c,)), ("wk", (c, c)),
                            ("bk", (c,)), ("wv", (c, c)), ("bv", (c,)),
                            ("wc", (c, embed_dim)), ("bc", (embed_dim,))):
            self.register_parameter(name, nn.Parameter(torch.zeros(shape)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[:2]
        t = x.flatten(2).transpose(1, 2).float()  # (B, H*W, C), (h, w) order
        t = torch.cat([t.mean(dim=1, keepdim=True), t], dim=1)
        t = t + self.pos_embed.float()
        hd = c // self.heads
        q = (t[:, :1] @ self.wq + self.bq).reshape(b, 1, self.heads, hd)
        k = (t @ self.wk + self.bk).reshape(b, -1, self.heads, hd)
        v = (t @ self.wv + self.bv).reshape(b, -1, self.heads, hd)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * (hd ** -0.5)
        weights = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(b, c)
        return out @ self.wc + self.bc


class ModifiedResNet(nn.Module):
    """The visual tower of a ``CLIPResNetSpec``; ``forward(images, dtype)``
    takes (B, S, S, 3) preprocessed images and returns (B, embed_dim) f32,
    not normalized (as the ViT tower's ``forward``)."""

    def __init__(self, spec: CLIPResNetSpec):
        super().__init__()
        w = spec.vision_width
        self.stem = Stem(w)
        cin = w
        for i, blocks in enumerate(spec.vision_layers):
            planes = w * 2 ** i
            self.add_module(f"stage{i + 1}",
                            Stage(cin, planes, blocks, stride=1 if i == 0 else 2))
            cin = planes * 4
        self.attnpool = AttentionPool(
            spec.num_image_tokens, spec.attn_dim, spec.vision_heads, spec.embed_dim)

    def forward(self, images: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        scope = full_f32_convs() if dtype == torch.float32 else contextlib.nullcontext()
        with scope:
            x = self.stem(images.to(dtype).permute(0, 3, 1, 2))
            for i in range(4):
                x = getattr(self, f"stage{i + 1}")(x)
        return self.attnpool(x)


# -------------------------------------------------------------------- init
# OpenAI's scheme, in place, from one torch.Generator (the numbers differ
# from the JAX package's jax.random init).


def _init_bn(bn: BatchNorm) -> None:
    with torch.no_grad():
        bn.scale.fill_(1.0)
        bn.bias.zero_()
        bn.mean.zero_()
        bn.var.fill_(1.0)


def _init_conv(conv: Conv, gen: torch.Generator) -> None:
    kh, kw, cin, _ = conv.kernel.shape
    with torch.no_grad():
        conv.kernel.normal_(0.0, (kh * kw * cin) ** -0.5, generator=gen)


def _init_block(block: Bottleneck, gen: torch.Generator) -> None:
    for conv in (block.conv1, block.conv2, block.conv3):
        _init_conv(conv, gen)
    for bn in (block.bn1, block.bn2, block.bn3):
        _init_bn(bn)
    # zero-init the last BN gamma of each block (OpenAI
    # initialize_parameters: residual branches start as identity)
    with torch.no_grad():
        block.bn3.scale.zero_()
    if block.downsample is not None:
        _init_conv(block.downsample.conv, gen)
        _init_bn(block.downsample.bn)


def init_visual_resnet(visual: ModifiedResNet, gen: torch.Generator) -> None:
    stem = visual.stem
    for conv, bn in ((stem.conv1, stem.bn1), (stem.conv2, stem.bn2),
                     (stem.conv3, stem.bn3)):
        _init_conv(conv, gen)
        _init_bn(bn)
    for i in range(4):
        stage = getattr(visual, f"stage{i + 1}")
        for blk in (stage.down, *stage.rest):
            _init_block(blk, gen)
    pool = visual.attnpool
    std = pool.wq.shape[0] ** -0.5  # OpenAI initialize_parameters attnpool std
    with torch.no_grad():
        for p in (pool.pos_embed, pool.wq, pool.wk, pool.wv, pool.wc):
            p.normal_(0.0, std, generator=gen)
        for p in (pool.bq, pool.bk, pool.bv, pool.bc):
            p.zero_()


def expected_visual_param_count(spec: CLIPResNetSpec) -> int:
    """Analytic parameter count of the visual tower, BN statistics
    included (they are leaves of the pytree, buffers in torch's)."""
    w = spec.vision_width

    def bn(c):
        return 4 * c

    total = (
        3 * 3 * 3 * (w // 2) + bn(w // 2)
        + 3 * 3 * (w // 2) * (w // 2) + bn(w // 2)
        + 3 * 3 * (w // 2) * w + bn(w)
    )
    cin = w
    for i, n_blocks in enumerate(spec.vision_layers):
        planes = w * (2 ** i)
        for b in range(n_blocks):
            c_in = cin if b == 0 else planes * 4
            total += c_in * planes + bn(planes)  # conv1
            total += 3 * 3 * planes * planes + bn(planes)  # conv2
            total += planes * planes * 4 + bn(planes * 4)  # conv3
            if b == 0:
                total += c_in * planes * 4 + bn(planes * 4)  # downsample
        cin = planes * 4
    c = spec.attn_dim
    total += spec.num_image_tokens * c  # pos embed
    total += 3 * (c * c + c)  # q/k/v proj
    total += c * spec.embed_dim + spec.embed_dim  # c_proj
    return total
