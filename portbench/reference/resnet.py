"""CLIP's modified-ResNet image tower, written plainly from the published
architecture (Radford et al. 2021, arXiv:2103.00020; ``github.com/openai/CLIP``,
``clip/model.py``: ``ModifiedResNet``, ``Bottleneck``, ``AttentionPool2d``).

  stem:  three 3x3 convs (stride 2, 1, 1; width/2, width/2, width
         channels), each followed by BatchNorm and ReLU, then a 2x2
         average pool
  stage: Bottleneck blocks (expansion 4; planes width, 2, 4, 8 x width);
         the first block of stages 2-4 has stride 2
  block: 1x1 -> BN -> ReLU -> 3x3 (padding 1) -> BN -> ReLU -> average
         pool (stride) -> 1x1 -> BN, added to the shortcut, then ReLU; the
         first block of a stage takes the shortcut through an average
         pool (stride), a 1x1 conv and BN
  pool:  the tokens (h, w order) with their mean first, plus a positional
         embedding; one query, the mean token, attends over all of them
         with separate q, k, v projections and heads of 32 x width /
         heads; then the output projection

Departures from ``clip/model.py``, each in the form and not in the
mathematics:
- Weights are a dict of the names ``portbench.data.weight_layout`` gives
  (the same seeded tensors are handed to the program): conv kernels HWIO
  (kh, kw, in, out), dense kernels (in, out). OpenAI's names differ
  (``conv1`` for ``stem.conv1``, ``layer1.0`` for ``stage1.down``,
  ``layer1.1`` for ``stage1.rest.0``, ``downsample.0`` for
  ``downsample.conv``, ``attnpool.q_proj.weight`` transposed for
  ``attnpool.wq``).
- BatchNorm in its eval form: (x - mean) / sqrt(var + 1e-5) * scale +
  bias, over statistics set from a seeded batch of photo-like images
  (``calibrate_batchnorm``), where a released checkpoint carries those of
  its training data.
- Images arrive channels-last, (B, S, S, 3), as the ViT reference takes
  them; the tower runs NCHW.
- ``F.multi_head_attention_forward`` is written out: q scaled by
  head_dim ** -0.5 after its product rather than before.
- float32 throughout (OpenAI runs float16 on a GPU).

``precision``: ``"fp32"`` computes every conv and product in float32 with
TF32 off for both matmuls and cuDNN (the reference); ``"fp8"`` rounds both
operands of every conv and every product to float8 e4m3 with a per-tensor
scale and accumulates in float32 (the control). BatchNorm, ReLU, pools and
softmax are float32 in both.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .clip import _fp8, _mm, _normalize, no_tf32

BN_EPS = 1e-5


def _conv(x, w, p, precision, stride=1, padding=0):
    kernel = w[p + ".kernel"].permute(3, 2, 0, 1)  # HWIO -> OIHW
    if precision == "fp8":
        x, kernel = _fp8(x), _fp8(kernel)
    return F.conv2d(x, kernel, stride=stride, padding=padding)


def _bn(x, w, p, calibrate=False):
    if calibrate:
        w[p + ".mean"].copy_(x.mean((0, 2, 3)))
        w[p + ".var"].copy_(x.var((0, 2, 3), unbiased=False))
    inv = torch.rsqrt(w[p + ".var"] + BN_EPS) * w[p + ".scale"]
    return (x - w[p + ".mean"][:, None, None]) * inv[:, None, None] + w[p + ".bias"][:, None, None]


def _pool(x, stride):
    return F.avg_pool2d(x, stride) if stride > 1 else x


def _stem(x, w, precision, calibrate=False):
    for i, stride in enumerate((2, 1, 1)):
        x = _conv(x, w, f"visual.stem.conv{i + 1}", precision, stride, 1)
        x = torch.relu(_bn(x, w, f"visual.stem.bn{i + 1}", calibrate))
    return _pool(x, 2)


def _bottleneck(x, w, p, stride, precision, calibrate=False):
    out = torch.relu(_bn(_conv(x, w, p + ".conv1", precision), w, p + ".bn1", calibrate))
    out = _conv(out, w, p + ".conv2", precision, padding=1)
    out = torch.relu(_bn(out, w, p + ".bn2", calibrate))
    out = _bn(_conv(_pool(out, stride), w, p + ".conv3", precision), w, p + ".bn3", calibrate)
    if p + ".downsample.conv.kernel" in w:
        x = _conv(_pool(x, stride), w, p + ".downsample.conv", precision)
        x = _bn(x, w, p + ".downsample.bn", calibrate)
    return torch.relu(out + x)


def blocks(model: dict):
    """(name prefix, stride) of every Bottleneck in order."""
    for s, n in enumerate(model["vision_layers"]):
        for b in range(n):
            p = f"visual.stage{s + 1}." + ("down" if b == 0 else f"rest.{b - 1}")
            yield p, 2 if s > 0 and b == 0 else 1


def _attnpool(x, w, heads, precision):
    b, c = x.shape[:2]
    p = "visual.attnpool."
    t = x.flatten(2).transpose(1, 2)  # (B, H*W, C)
    t = torch.cat([t.mean(1, keepdim=True), t], 1) + w[p + "pos_embed"]
    hd = c // heads

    def proj(a, name):
        return _mm(a, w[p + "w" + name], precision) + w[p + "b" + name]

    q = proj(t[:, :1], "q").reshape(b, 1, heads, hd).transpose(1, 2)
    k = proj(t, "k").reshape(b, -1, heads, hd).transpose(1, 2)
    v = proj(t, "v").reshape(b, -1, heads, hd).transpose(1, 2)
    logits = _mm(q, k.transpose(-1, -2), precision) * hd ** -0.5
    out = _mm(torch.softmax(logits, -1), v, precision).reshape(b, c)
    return proj(out, "c")


@torch.no_grad()
def calibrate_batchnorm(w: dict, images: torch.Tensor, model: dict) -> None:
    """Sets every BatchNorm's ``mean`` and ``var`` in ``w``, in place, to
    the statistics of its input over ``images`` ((B, S, S, 3) normalized
    float32 pixels), in float32 with TF32 off: each layer's on the output
    of the layers before it, already set. A served model's running
    statistics are those of the data it was trained on, and drawn ones
    that are not leave the stream's per-channel offsets in place, which
    make every photo's embedding nearly the same."""
    with no_tf32():
        x = _stem(images.permute(0, 3, 1, 2).contiguous(), w, "fp32", calibrate=True)
        for p, stride in blocks(model):
            x = _bottleneck(x, w, p, stride, "fp32", calibrate=True)


@torch.no_grad()
def encode_image(w: dict, images: torch.Tensor, model: dict, precision: str = "fp32"):
    """(B, S, S, 3) normalized float32 pixels -> (B, embed_dim) unit rows."""
    with no_tf32():
        x = _stem(images.permute(0, 3, 1, 2).contiguous(), w, precision)
        for p, stride in blocks(model):
            x = _bottleneck(x, w, p, stride, precision)
        return _normalize(_attnpool(x, w, model["vision_heads"], precision))
