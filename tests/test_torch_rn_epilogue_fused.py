"""The modified ResNet's fused epilogue kernels (``ops/csrc/rn_epilogue.cu``)
against their plain chains on the card, bit for bit: each of the five at
every (channels, size) that RN50x64 at 448 px gives it, at an odd size
(floor pooling), and with NaN, infinities and signed zeros in the inputs
and the affine; the RN50x64 and RN50 towers fused against plain; and the
chains' refusals on the kernel's route, and a float32 conv output on the
plain ops.

Imports neither JAX nor the JAX package, so the file also runs on a GPU
machine without them (``python -m pytest --noconftest -m gpu
tests/test_torch_rn_epilogue_fused.py``). Every test skips in its body
where no CUDA device is present."""

import pytest
import torch

from evossearch_tpu_torch.core import CLIP_MODEL_SPECS
from evossearch_tpu_torch.models import resnet
from evossearch_tpu_torch.ops import fused, rn_epilogue
from evossearch_tpu_torch.utils import Counters

BF = torch.bfloat16
BATCH = 2

# (channels, size) of each chain in RN50x64 at 448 px: the stem at 224,
# the stages at 112, 56, 28 and 14 (planes 128 to 1,024, outputs 4x)
BN_RELU = [(64, 224), (128, 112), (256, 112), (256, 56), (512, 56), (512, 28),
           (1024, 28), (1024, 14)]
BN_RELU_POOL = [(128, 224), (256, 112), (512, 56), (1024, 28)]
BN_ADD_RELU = [(512, 112), (1024, 56), (2048, 28), (4096, 14)]
BN_BN_ADD_RELU = BN_ADD_RELU
AVG_POOL = [(512, 112), (1024, 56), (2048, 28)]


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")


def _gen(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


def activation(c: int, h: int, w: int | None = None, seed: int = 0,
               special: bool = False) -> torch.Tensor:
    """A channels-last (BATCH, c, h, w) bf16 conv output: normal values at
    a conv output's scale; with ``special`` also NaN, +-inf, -0, +0 and
    values near bf16's largest (whose affine can overflow)."""
    g = _gen(seed)
    x = torch.randn(BATCH, h, w or h, c, generator=g, device="cuda") * 2
    if special:
        flat = x.view(-1)
        for step, value in ((97, float("nan")), (89, float("inf")), (83, float("-inf")),
                            (79, -0.0), (73, 0.0), (67, 3.0e38), (61, -3.0e38)):
            flat[::step] = value
    return x.to(BF).permute(0, 3, 1, 2)


def affine(c: int, seed: int, special: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """A BatchNorm's float32 (scale, shift); with ``special`` a zero scale
    (0 * inf is NaN), negative scales beside a -0 shift (-0 outputs) and an
    infinite shift."""
    g = _gen(seed + 1000)
    scale = 1 + 0.5 * torch.randn(c, generator=g, device="cuda")
    shift = 0.5 * torch.randn(c, generator=g, device="cuda")
    if special:
        scale[::7] = 0.0
        scale[1::5] = -1.5
        shift[1::5] = -0.0
        shift[3::11] = float("inf")
    return scale, shift


def _same_bits(got: torch.Tensor, want: torch.Tensor) -> None:
    assert got.shape == want.shape and got.dtype == want.dtype == BF
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got.contiguous().view(torch.int16), want.contiguous().view(torch.int16))


def _launched(call) -> torch.Tensor:
    with fused.counting(Counters()) as c, torch.no_grad():
        out = call()
    torch.cuda.synchronize()
    snap = c.snapshot()
    assert snap[rn_epilogue.FUSED] == 1 and snap[rn_epilogue.PASSES] == 1
    return out


CASES = [(c, h, None, False) for c, h in BN_RELU] + [(64, 15, 17, False), (64, 32, None, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("c, h, w, special", CASES)
def test_bn_relu_bit_equal(c, h, w, special):
    _need_gpu()
    x, (s, b) = activation(c, h, w, c + h, special), affine(c, c, special)
    _same_bits(_launched(lambda: rn_epilogue.bn_relu(x, s, b)),
               rn_epilogue.bn_relu_plain(x, s, b))


@pytest.mark.gpu
@pytest.mark.parametrize("c, h, w, special",
                         [(c, h, None, False) for c, h in BN_RELU_POOL]
                         + [(64, 15, 17, False), (64, 33, None, True)])
def test_bn_relu_pool_bit_equal(c, h, w, special):
    _need_gpu()
    x, (s, b) = activation(c, h, w, c + h + 1, special), affine(c, c + 1, special)
    _same_bits(_launched(lambda: rn_epilogue.bn_relu(x, s, b, 2)),
               rn_epilogue.bn_relu_plain(x, s, b, 2))


@pytest.mark.gpu
@pytest.mark.parametrize("c, h, w, special",
                         [(c, h, None, False) for c, h in BN_ADD_RELU]
                         + [(64, 15, 17, False), (64, 32, None, True)])
def test_bn_add_relu_bit_equal(c, h, w, special):
    _need_gpu()
    x, r = activation(c, h, w, c + h + 2, special), activation(c, h, w, c + h + 3, special)
    s, b = affine(c, c + 2, special)
    _same_bits(_launched(lambda: rn_epilogue.bn_add_relu(x, s, b, r)),
               rn_epilogue.bn_add_relu_plain(x, s, b, r))


@pytest.mark.gpu
@pytest.mark.parametrize("c, h, w, special",
                         [(c, h, None, False) for c, h in BN_BN_ADD_RELU]
                         + [(64, 15, 17, False), (64, 32, None, True)])
def test_bn_bn_add_relu_bit_equal(c, h, w, special):
    _need_gpu()
    x, y = activation(c, h, w, c + h + 4, special), activation(c, h, w, c + h + 5, special)
    (s, b), (s2, b2) = affine(c, c + 3, special), affine(c, c + 4, special)
    _same_bits(_launched(lambda: rn_epilogue.bn_bn_add_relu(x, s, b, lambda: (y, s2, b2))),
               rn_epilogue.bn_bn_add_relu_plain(x, s, b, y, s2, b2))


@pytest.mark.gpu
@pytest.mark.parametrize("c, h, w, special",
                         [(c, h, None, False) for c, h in AVG_POOL]
                         + [(64, 15, 17, False), (64, 33, None, True)])
def test_avg_pool_bit_equal(c, h, w, special):
    _need_gpu()
    x = activation(c, h, w, c + h + 6, special)
    _same_bits(_launched(lambda: rn_epilogue.avg_pool(x, 2)), rn_epilogue.avg_pool_plain(x, 2))


def resnet_tower(name: str, seed: int = 0) -> resnet.ModifiedResNet:
    """The tower of ``name`` at published widths on the card: OpenAI's
    init, then BatchNorm statistics and affines away from identity, so
    every epilogue does work."""
    model = resnet.ModifiedResNet(CLIP_MODEL_SPECS[name])
    g = torch.Generator().manual_seed(seed)
    resnet.init_visual_resnet(model, g)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, resnet.BatchNorm):
                c = mod.scale.shape[0]
                mod.scale.copy_(1 + 0.2 * torch.randn(c, generator=g))
                mod.bias.copy_(0.1 * torch.randn(c, generator=g))
                mod.mean.copy_(0.1 * torch.randn(c, generator=g))
                mod.var.copy_(torch.rand(c, generator=g) + 0.5)
        for stage in (model.stage1, model.stage2, model.stage3, model.stage4):
            for blk in (stage.down, *stage.rest):
                blk.bn3.scale.mul_(0.3)  # residual branches smaller than the stream
    return model.cuda().eval()


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["RN50x64", "RN50"])
def test_tower_fused_equals_plain(name, monkeypatch):
    """The tower at batch 4 through the kernels equals the plain ops' tower
    bit for bit; every chain launched, none plain."""
    _need_gpu()
    model = resnet_tower(name)
    spec = CLIP_MODEL_SPECS[name]
    images = torch.randn(4, spec.image_size, spec.image_size, 3, generator=_gen(5),
                         device="cuda")
    with torch.no_grad(), fused.counting(Counters()) as c:
        kernels = model(images, BF)
    snap = c.snapshot()
    assert snap[rn_epilogue.FUSED] > 0 and rn_epilogue.PLAIN_CUDA not in snap
    monkeypatch.setattr(fused, "on_card", lambda x: False)
    with torch.no_grad():
        plain = model(images, BF)
    assert bool(torch.isfinite(kernels).all())
    assert torch.equal(kernels, plain)


@pytest.mark.gpu
def test_wrappers_raise_on_what_the_kernels_do_not_take():
    _need_gpu()
    x = activation(64, 8, seed=1)
    s, b = affine(64, 1)
    bad = {
        "channels-last": x.contiguous(),  # NCHW-contiguous
        "multiple of 8": activation(60, 8, seed=2),
        "aligned": torch.empty(BATCH * 8 * 8 * 64 + 1, dtype=BF, device="cuda")[1:]
        .view(BATCH, 8, 8, 64).permute(0, 3, 1, 2),
    }
    with torch.no_grad():
        for what, t in bad.items():
            c = t.shape[1]
            for call in (lambda: rn_epilogue.bn_relu(t, s[:c], b[:c]),
                         lambda: rn_epilogue.bn_relu(t, s[:c], b[:c], 2),
                         lambda: rn_epilogue.bn_add_relu(t, s[:c], b[:c], t),
                         lambda: rn_epilogue.bn_bn_add_relu(t, s[:c], b[:c],
                                                            lambda: (t, s[:c], b[:c])),
                         lambda: rn_epilogue.avg_pool(t, 2)):
                with pytest.raises(ValueError, match=what):
                    call()
        # a float32 residual or shortcut beside a bf16 conv output is refused
        with pytest.raises(ValueError, match="bfloat16"):
            rn_epilogue.bn_add_relu(x, s, b, x.float())
        with pytest.raises(ValueError, match="bfloat16"):
            rn_epilogue.bn_bn_add_relu(x, s, b, lambda: (x.float(), s, b))
    # a float32 conv output is the plain route's: the plain ops, counted
    xf = x.float()
    with torch.no_grad(), fused.counting(Counters()) as c:
        got = {"bn_relu": rn_epilogue.bn_relu(xf, s, b),
               "bn_add_relu": rn_epilogue.bn_add_relu(xf, s, b, xf),
               "bn_bn_add_relu": rn_epilogue.bn_bn_add_relu(xf, s, b, lambda: (xf, s, b)),
               "avg_pool": rn_epilogue.avg_pool(xf, 2)}
    assert c.snapshot()[rn_epilogue.PLAIN_CUDA] == 4 and rn_epilogue.FUSED not in c.snapshot()
    assert torch.equal(got["bn_relu"], rn_epilogue.bn_relu_plain(xf, s, b))
    assert torch.equal(got["bn_add_relu"], rn_epilogue.bn_add_relu_plain(xf, s, b, xf))
    assert torch.equal(got["bn_bn_add_relu"], rn_epilogue.bn_bn_add_relu_plain(xf, s, b, xf, s, b))
    assert torch.equal(got["avg_pool"], rn_epilogue.avg_pool_plain(xf, 2))
