"""The modified ResNet's conv epilogues (``evossearch_tpu_torch/models/
resnet.py``, ``ops/rn_epilogue.py``) on the CPU: ``rn_epilogue_passes``
and ``rn_epilogue_bytes`` against counts worked from the shapes alone, on
the plain route (float32, and bf16 under autograd) and on the fused
kernels' route (bf16 with nothing recorded), at a tiny spec on the CPU and
at RN50 and RN50x64 on the meta device (no memory, no arithmetic); the
dispatch between the routes and its counters; the chains' refusals;
nothing counted on CPU tensors or outside ``ops.fused.counting``; the
tower's output bit-equal with counting on and off and on either route;
the stem, stage and attention-pool spans only while a profiler records;
the engine's image encodes counting into its ``Counters``; the model
against a frozen copy of its code from before the chains chose their own
route (the same aten ops in the same order and the same peak of live
bytes on the plain route, the same launches with the same arguments on
the kernels' route); and the one device test of ``ops/fused.py`` moving
both kernel families.

A simulated card (``fused.on_card`` patched to True) stands in for a
CUDA device, as in ``tests/test_torch_tower.py``; on it the kernels'
launches (``fused.launch``) run a stand-in that computes each entry
point's plain chain from the arguments the chains pass. The kernels
themselves run on the card: ``tests/test_torch_rn_epilogue_fused.py``."""

import contextlib
import dataclasses
import weakref

import numpy as np
import pytest
import torch

import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from evossearch_tpu_torch.core import CLIP_MODEL_SPECS
from evossearch_tpu_torch.core.constants import CLIPResNetSpec
from evossearch_tpu_torch.models import resnet
from evossearch_tpu_torch.ops import _build, fused, rn_epilogue, tower
from evossearch_tpu_torch.utils import profiling
from evossearch_tpu_torch.utils.logging import Counters

PASSES, BYTES = rn_epilogue.PASSES, rn_epilogue.BYTES
FUSED, PLAIN = rn_epilogue.FUSED, rn_epilogue.PLAIN_CUDA

# multi-block and single-block stages, 64 px -> a 2x2 final grid
TINY_RN = CLIPResNetSpec(
    name="tiny-rn", image_size=64,
    vision_width=16, vision_layers=(2, 1, 1, 2), vision_heads=8,
    text_width=48, text_layers=2, text_heads=4,
    vocab_size=512, context_length=16, embed_dim=32,
)
# an odd input size: floor semantics in the stem's stride and every pool
ODD_RN = dataclasses.replace(TINY_RN, name="odd-rn", image_size=70)

SPANS = ["rn_stem", "rn_stage1", "rn_stage2", "rn_stage3", "rn_stage4", "rn_attnpool"]


def expected_epilogue(spec: CLIPResNetSpec, batch: int, dtype: torch.dtype) -> tuple[int, int]:
    """(passes, bytes) of the tower's epilogues, from the shapes alone.

    BatchNorm over n values of C channels: in bf16 a cast to f32, the
    multiply by the per-channel scale, the add of the per-channel bias
    and the cast back, 4 passes reading and writing 2n(e) + 24n + 8C
    bytes (e the compute dtype's size); in f32 the two casts are no-ops.
    A ReLU reads and writes the tensor once; the residual add reads two.
    An average pool of stride s casts to f32, pools to n / s^2 (floor)
    and casts back."""
    e = torch.finfo(dtype).bits // 8
    passes = nbytes = 0

    def bn(c, h):
        nonlocal passes, nbytes
        n = batch * c * h * h
        if e == 4:
            passes, nbytes = passes + 2, nbytes + 16 * n + 8 * c
        else:
            passes, nbytes = passes + 4, nbytes + 2 * n * e + 24 * n + 8 * c

    def relu(c, h):
        nonlocal passes, nbytes
        passes, nbytes = passes + 1, nbytes + 2 * batch * c * h * h * e

    def add(c, h):
        nonlocal passes, nbytes
        passes, nbytes = passes + 1, nbytes + 3 * batch * c * h * h * e

    def pool(c, h, s):
        nonlocal passes, nbytes
        if s == 1:
            return h
        ho = h // s
        n, m = batch * c * h * h, batch * c * ho * ho
        if e == 4:
            passes, nbytes = passes + 1, nbytes + 4 * n + 4 * m
        else:
            passes, nbytes = passes + 3, nbytes + (n * e + 4 * n) + (4 * n + 4 * m) + (4 * m + m * e)
        return ho

    w = spec.vision_width
    h = (spec.image_size - 1) // 2 + 1  # the stem's stride-2 3x3 conv, padding 1
    for c in (w // 2, w // 2, w):
        bn(c, h)
        relu(c, h)
    h = pool(w, h, 2)
    cin = w
    for i, blocks in enumerate(spec.vision_layers):
        planes, stride = w * 2 ** i, 1 if i == 0 else 2
        for b in range(blocks):
            for _ in range(2):  # conv1 and conv2
                bn(planes, h)
                relu(planes, h)
            if b == 0:
                ho = pool(planes, h, stride)
                bn(4 * planes, ho)  # conv3
                pool(cin, h, stride)
                bn(4 * planes, ho)  # the shortcut's projection
                h = ho
            else:
                bn(4 * planes, h)
            add(4 * planes, h)
            relu(4 * planes, h)
        cin = 4 * planes
    return passes, nbytes


def expected_fused(spec: CLIPResNetSpec, batch: int) -> tuple[int, int]:
    """(launches, bytes) of the tower's epilogues on the fused kernels'
    route (bf16), from the shapes alone: one launch a chain, each reading
    its bf16 inputs and writing its bf16 output once, plus 8 bytes a
    channel of each BatchNorm's scale and shift. Over n values: BatchNorm
    + ReLU 4n; the residual chains 6n (a tail block's input, or a down
    block's shortcut conv output); a pool of stride 2 to m = n / 4 values
    (floor) reads the m 2x2 windows and writes m, 10m. So the stem's three
    BatchNorms are 3 launches (the last pooled), a tail block 3 (bn1, bn2,
    bn3 with the residual), a down block 3 where its stride is 1 and 4
    where it is 2 (bn2 pooled, and the shortcut's pool)."""
    launches = nbytes = 0

    def launch(b):
        nonlocal launches, nbytes
        launches, nbytes = launches + 1, nbytes + b

    w = spec.vision_width
    h = (spec.image_size - 1) // 2 + 1  # the stem's stride-2 3x3 conv, padding 1
    for c in (w // 2, w // 2):
        launch(4 * batch * c * h * h + 8 * c)
    h //= 2
    launch(10 * batch * w * h * h + 8 * w)
    cin = w
    for i, blocks in enumerate(spec.vision_layers):
        planes, stride = w * 2 ** i, 1 if i == 0 else 2
        for b in range(blocks):
            launch(4 * batch * planes * h * h + 8 * planes)  # bn1
            if b == 0 and stride == 2:
                ho = h // 2
                launch(10 * batch * planes * ho * ho + 8 * planes)  # bn2, pooled
                launch(10 * batch * cin * ho * ho)  # the shortcut's pool
                h = ho
            else:
                launch(4 * batch * planes * h * h + 8 * planes)  # bn2
            bns = 2 if b == 0 else 1  # a down block's shortcut BatchNorm
            launch(6 * batch * 4 * planes * h * h + 8 * bns * 4 * planes)
        cin = 4 * planes
    return launches, nbytes


def _stand_in(name, device, args, counter):
    """A kernel launch on the simulated card: the entry point's plain chain
    computed from the arguments the chain passes, written into its
    output, counted as ``fused.launch`` counts."""
    assert len(args) + 1 == len(_build._SIGNATURES[name][2])  # and the stream
    assert counter == FUSED
    with fused.counting(None):
        if name == "rn_bn_relu":
            x, s, b, out, pixels, c = args
            want = rn_epilogue.bn_relu_plain(x, s, b)
        elif name == "rn_bn_relu_pool":
            x, s, b, out, n, h, w, c = args
            assert (n, c, h, w) == tuple(x.shape)
            want = rn_epilogue.bn_relu_plain(x, s, b, 2)
        elif name == "rn_bn_add_relu":
            x, s, b, r, out, pixels, c = args
            want = rn_epilogue.bn_add_relu_plain(x, s, b, r)
        elif name == "rn_bn_bn_add_relu":
            x, s, b, y, s2, b2, out, pixels, c = args
            want = rn_epilogue.bn_bn_add_relu_plain(x, s, b, y, s2, b2)
        else:
            assert name == "rn_avg_pool"
            x, out, n, h, w, c = args
            assert (n, c, h, w) == tuple(x.shape)
            want = rn_epilogue.avg_pool_plain(x, 2)
        if name in ("rn_bn_relu", "rn_bn_add_relu", "rn_bn_bn_add_relu"):
            assert pixels * c == x.numel() and c == x.shape[1]
        assert out.dtype == x.dtype == torch.bfloat16 and out.shape == want.shape
        assert out.is_contiguous(memory_format=torch.channels_last)
        out.copy_(want)
    fused.count(counter)


def _tower(spec, seed=0):
    """The tower with every parameter drawn from ``seed`` (BatchNorm
    statistics too, variances positive)."""
    model = resnet.ModifiedResNet(spec)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".var"):
                p.copy_(torch.rand(p.shape, generator=g) + 0.5)
            else:
                p.copy_(torch.randn(p.shape, generator=g) * (p.shape[0] ** -0.5 if p.dim() > 1 else 0.1))
    return model.eval()


def _images(spec, n, seed=1, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, spec.image_size, spec.image_size, 3, generator=g).to(dtype)


@pytest.fixture
def card(monkeypatch):
    """Every tensor counts as on the card; launches run ``_stand_in``."""
    monkeypatch.setattr(fused, "on_card", lambda x: True)
    monkeypatch.setattr(fused, "launch", _stand_in)


def _count(model, images, dtype, grad=False):
    """The tower's output and counters; with ``grad`` autograd records
    (the parameters require grad), which takes the plain route."""
    counters = Counters()
    with torch.set_grad_enabled(grad), fused.counting(counters):
        out = model(images, dtype)
    return out.detach(), counters.snapshot()


def _plain_counts(spec, batch, dtype):
    """The counters of a forward on the card's plain route: every chain
    counted as a plain call."""
    passes, nbytes = expected_epilogue(spec, batch, dtype)
    return {PASSES: passes, BYTES: nbytes, PLAIN: expected_fused(spec, batch)[0]}


def _fused_counts(spec, batch):
    launches, nbytes = expected_fused(spec, batch)
    return {PASSES: launches, BYTES: nbytes, FUSED: launches}


# the plain route on the card: float32, and bf16 under autograd
ROUTES = [(torch.bfloat16, True), (torch.float32, False)]


@pytest.mark.parametrize("dtype, grad", ROUTES)
@pytest.mark.parametrize("spec, batch", [(TINY_RN, 3), (ODD_RN, 2)])
def test_counts_equal_the_shapes(spec, batch, dtype, grad, card):
    _, got = _count(_tower(spec), _images(spec, batch), dtype, grad)
    assert got == _plain_counts(spec, batch, dtype)


@pytest.mark.parametrize("dtype, grad", ROUTES)
@pytest.mark.parametrize("name, batch", [("RN50", 4), ("RN50x64", 2)])
def test_counts_equal_the_shapes_at_published_widths(name, batch, dtype, grad, card):
    """Full-size towers on the meta device: shapes only."""
    spec = CLIP_MODEL_SPECS[name]
    with torch.device("meta"):
        model = resnet.ModifiedResNet(spec)
    images = torch.empty(batch, spec.image_size, spec.image_size, 3, device="meta", dtype=dtype)
    out, got = _count(model, images, dtype, grad)
    assert out.shape == (batch, spec.embed_dim)
    assert got == _plain_counts(spec, batch, dtype)


@pytest.mark.parametrize("spec, batch", [(TINY_RN, 3), (ODD_RN, 2)])
def test_fused_counts_equal_the_shapes(spec, batch, card):
    """bf16 with nothing recorded: one launch a chain, its bytes from the
    shapes, no plain call; the output equals the plain route's bit for
    bit (the stand-in computes each chain's plain ops)."""
    model, images = _tower(spec), _images(spec, batch)
    got_out, got = _count(model, images, torch.bfloat16)
    assert got == _fused_counts(spec, batch)
    want_out, _ = _count(model, images, torch.bfloat16, grad=True)
    assert torch.equal(got_out, want_out)


@pytest.mark.parametrize("name, batch", [("RN50", 4), ("RN50x64", 2)])
def test_fused_counts_equal_the_shapes_at_published_widths(name, batch, card, monkeypatch):
    """On the meta device, whose convs return NCHW strides where cuDNN and
    the CPU return channels-last for channels-last operands, so the convs
    are given the card's layout."""
    conv2d = F.conv2d
    monkeypatch.setattr(F, "conv2d", lambda *a, **k: conv2d(*a, **k).contiguous(
        memory_format=torch.channels_last))
    spec = CLIP_MODEL_SPECS[name]
    with torch.device("meta"):
        model = resnet.ModifiedResNet(spec)
    images = torch.empty(batch, spec.image_size, spec.image_size, 3, device="meta",
                         dtype=torch.bfloat16)
    out, got = _count(model, images, torch.bfloat16)
    assert out.shape == (batch, spec.embed_dim)
    assert got == _fused_counts(spec, batch)


def test_rn50x64_fused_epilogue_per_image_is_pinned():
    """RN50x64 at 448 px on the kernels' route: 198 launches a forward (3
    in the stem, 3 a tail block, 3 and 4 in the down blocks of stride 1
    and 2), 1,162,915,840 bytes at batch 1, 7.3 times fewer than the
    plain route's 8,507,076,608; each further image adds that less the
    per-channel vectors."""
    spec = CLIP_MODEL_SPECS["RN50x64"]
    one, two = (expected_fused(spec, b) for b in (1, 2))
    assert one[0] == two[0] == 198
    assert one[1] == 1_162_915_840
    assert two[1] - one[1] == 1_162_915_840 - 8 * _bn_channels(spec)


def test_rn50x64_epilogue_per_image_is_pinned():
    """RN50x64 at 448 px in bf16: 199 BatchNorms of 4 passes, 1,076
    passes a forward, 8,507,076,608 bytes at batch 1; each further image
    adds that less the per-channel vectors (8 bytes a channel of each
    BatchNorm), which a forward reads once whatever its batch."""
    spec = CLIP_MODEL_SPECS["RN50x64"]
    one, two = (expected_epilogue(spec, b, torch.bfloat16) for b in (1, 2))
    assert one[0] == two[0] == 1076
    assert two[1] - one[1] == 8_507_076_608 - 8 * _bn_channels(spec)
    assert one[1] == 8_507_076_608


def _bn_channels(spec):
    w = spec.vision_width
    total = w // 2 + w // 2 + w
    for i, blocks in enumerate(spec.vision_layers):
        planes = w * 2 ** i
        total += blocks * (planes + planes + 4 * planes) + 4 * planes
    return total


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_nothing_counted_on_cpu_tensors(dtype):
    model = _tower(TINY_RN)
    _, got = _count(model, _images(TINY_RN, 2), dtype)
    assert got == {}


def test_nothing_counted_outside_counting(card):
    """Neither route counts outside ``counting``: the plain one (bf16
    under autograd) and the kernels' (bf16, nothing recorded)."""
    model, images = _tower(TINY_RN), _images(TINY_RN, 2)
    counters = Counters()
    with fused.counting(counters):
        pass
    model(images, torch.bfloat16)
    with torch.no_grad():
        model(images, torch.bfloat16)
    assert counters.snapshot() == {}
    _, got = _count(model, images, torch.bfloat16, grad=True)
    assert got[PASSES] == expected_epilogue(TINY_RN, 2, torch.bfloat16)[0]
    _, got = _count(model, images, torch.bfloat16)
    assert got[PASSES] == expected_fused(TINY_RN, 2)[0]


@pytest.mark.parametrize("dtype, grad", ROUTES)
def test_output_bit_equal_with_counting_on_and_off(dtype, grad, monkeypatch):
    """On the plain route (the kernels' needs the stand-in: see
    ``test_fused_counts_equal_the_shapes``)."""
    model, images = _tower(TINY_RN), _images(TINY_RN, 3)
    with torch.no_grad():
        plain = model(images, dtype)
    monkeypatch.setattr(fused, "on_card", lambda x: True)
    counted, got = _count(model, images, dtype, grad)
    assert got[PASSES] > 0
    assert torch.equal(counted, plain)


def test_cpu_route_builds_nothing(monkeypatch):
    """CPU tensors, any dtype, grad or not: the plain ops, no kernel built
    or loaded, nothing counted."""
    def no_build(*args, **kwargs):
        raise AssertionError("the CPU route must not build or load a kernel")

    monkeypatch.setattr(_build, "entry", no_build)
    model, images = _tower(ODD_RN), _images(ODD_RN, 2)
    for dtype, grad in ROUTES + [(torch.bfloat16, False)]:
        _, got = _count(model, images, dtype, grad)
        assert got == {}


def test_route_by_dtype_and_autograd(card):
    """On the card each chain launches its kernel for bf16 when autograd
    records nothing (grad mode off, or no operand requiring grad), and
    takes the plain ops, counted as a plain call, for float32 or under
    autograd; the routes give the same bits in bf16."""
    model, images = _tower(TINY_RN), _images(TINY_RN, 2)
    chains = expected_fused(TINY_RN, 2)[0]
    out = {}
    for key, dtype, grad, frozen in (("fused", torch.bfloat16, False, False),
                                     ("fused_grad_mode", torch.bfloat16, True, True),
                                     ("autograd", torch.bfloat16, True, False),
                                     ("f32", torch.float32, False, False)):
        model.requires_grad_(not frozen)
        out[key], got = _count(model, images, dtype, grad)
        assert got.get(FUSED, 0) + got.get(PLAIN, 0) == chains
        assert got.get(FUSED, 0) == (chains if key.startswith("fused") else 0)
        assert tower.FUSED not in got and tower.PLAIN_CUDA not in got
    assert torch.equal(out["fused"], out["autograd"])
    model.requires_grad_(False)  # which the CPU's float32 products notice
    frozen, _ = _count(model, images, torch.bfloat16)
    assert torch.equal(frozen, out["fused_grad_mode"])
    assert out["f32"].dtype == torch.float32


def _act(n=2, c=16, h=6, w=6, dtype=torch.bfloat16, seed=9):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, h, w, c, generator=g).to(dtype)
    return x.permute(0, 3, 1, 2)  # channels-last (N, C, H, W)


def test_wrappers_raise_on_what_the_kernels_do_not_take(card):
    """On the kernels' route (bf16 on the card, nothing recorded) each
    chain refuses what its kernel does not take; a float32 conv output is
    the plain route's, and takes the plain ops."""
    x, r = _act(), _act(seed=10)
    s, b = torch.ones(16), torch.zeros(16)
    nchw = x.contiguous()  # NCHW-contiguous
    base = torch.randn(2 * 6 * 6 * 16 + 1).to(torch.bfloat16)
    unaligned = base[1:].view(2, 6, 6, 16).permute(0, 3, 1, 2)
    narrow = _act(c=12)
    calls = {
        "bn_relu": lambda t, c=16: rn_epilogue.bn_relu(t, s[:c], b[:c]),
        "bn_relu_pool": lambda t, c=16: rn_epilogue.bn_relu(t, s[:c], b[:c], 2),
        "bn_add_relu": lambda t, c=16: rn_epilogue.bn_add_relu(t, s[:c], b[:c], t),
        "bn_bn_add_relu": lambda t, c=16: rn_epilogue.bn_bn_add_relu(
            t, s[:c], b[:c], lambda: (t, s[:c], b[:c])),
        "avg_pool": lambda t, c=16: rn_epilogue.avg_pool(t, 2),
    }
    plain = {
        "bn_relu": lambda t: rn_epilogue.bn_relu_plain(t, s, b),
        "bn_relu_pool": lambda t: rn_epilogue.bn_relu_plain(t, s, b, 2),
        "bn_add_relu": lambda t: rn_epilogue.bn_add_relu_plain(t, s, b, t),
        "bn_bn_add_relu": lambda t: rn_epilogue.bn_bn_add_relu_plain(t, s, b, t, s, b),
        "avg_pool": lambda t: rn_epilogue.avg_pool_plain(t, 2),
    }
    with torch.no_grad():
        for name, call in calls.items():
            with pytest.raises(ValueError, match="channels-last"):
                call(nchw)
            with pytest.raises(ValueError, match="multiple of 8"):
                call(narrow, 12)
            with pytest.raises(ValueError, match="aligned"):
                call(unaligned)
            call(x)  # and takes what it should
            with fused.counting(Counters()) as c:
                assert torch.equal(call(x.float()), plain[name](x.float()))
            assert c.snapshot()[PLAIN] == 1 and FUSED not in c.snapshot()
        with pytest.raises(ValueError, match="shape"):
            rn_epilogue.bn_relu(x, s[:8], b[:8])
        with pytest.raises(ValueError, match="float32"):
            rn_epilogue.bn_relu(x, s.double(), b)
        with pytest.raises(ValueError, match="residual"):
            rn_epilogue.bn_add_relu(x, s, b, r[:, :, :4])
        with pytest.raises(ValueError, match="channels-last"):
            rn_epilogue.bn_add_relu(x, s, b, r.contiguous())
        with pytest.raises(ValueError, match="bfloat16"):
            rn_epilogue.bn_add_relu(x, s, b, r.float())
        with pytest.raises(ValueError, match="shortcut"):
            rn_epilogue.bn_bn_add_relu(x, s, b, lambda: (r[:1], s, b))
        with pytest.raises(ValueError, match="bfloat16"):
            rn_epilogue.bn_bn_add_relu(x, s, b, lambda: (r.float(), s, b))
        for stride in (3, 4):
            with pytest.raises(ValueError, match="2x2"):
                rn_epilogue.bn_relu(x, s, b, stride)
            with pytest.raises(ValueError, match="2x2"):
                rn_epilogue.avg_pool(x, stride)
        assert rn_epilogue.avg_pool(x, 1) is x


def test_counting_launches_the_same_ops_in_the_same_order(monkeypatch):
    """The dispatched aten ops, in order, are those of the tower before
    the counters: BatchNorm's affine as cast, mul, add, cast."""
    bn = resnet.BatchNorm(8)
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in (bn.scale, bn.bias, bn.mean):
            p.copy_(torch.randn(8, generator=g))
        bn.var.copy_(torch.rand(8, generator=g) + 0.5)
    x = torch.randn(2, 8, 5, 5, generator=g).to(torch.bfloat16)
    runs = []
    for on_card in (False, True):
        monkeypatch.setattr(fused, "on_card", lambda t, on=on_card: on)
        with torch.no_grad(), fused.counting(Counters()), _Ops() as mode:
            y = bn(x)
        runs.append((mode.ops, y))
    assert runs[0][0] == runs[1][0]
    assert torch.equal(runs[0][1], runs[1][1])
    ops = [o for o in runs[0][0] if "_to_copy" in o or o.startswith(("aten.mul", "aten.add"))]
    assert ops[-4:] == ["aten._to_copy.default", "aten.mul.Tensor", "aten.add.Tensor",
                        "aten._to_copy.default"]
    with torch.no_grad():
        old = (x.float() * (bn.scale * torch.rsqrt(bn.var + resnet.BN_EPS))[:, None, None]
               + (bn.bias - bn.mean * bn.scale * torch.rsqrt(bn.var + resnet.BN_EPS))[:, None, None])
    assert torch.equal(runs[0][1], old.to(torch.bfloat16))


class _LiveBytes(TorchDispatchMode):
    """The bytes held by the storages of tensors that ops made inside the
    mode (a view adds none), read as each op returns (``trace``), and the
    most of them at once (``peak``)."""

    def __init__(self):
        super().__init__()
        self.refs, self.peak, self.trace = [], 0, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.refs += [weakref.ref(t) for t in (out if isinstance(out, tuple) else (out,))
                      if isinstance(t, torch.Tensor)]
        live = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in (r() for r in self.refs) if t is not None}
        self.trace.append(sum(live.values()))
        self.peak = max(self.peak, self.trace[-1])
        return out


def _old_batch_norm(bn, x):
    """``BatchNorm.forward`` before the counters: one expression."""
    scale = bn.scale.float() * torch.rsqrt(bn.var.float() + resnet.BN_EPS)
    bias = bn.bias.float() - bn.mean.float() * scale
    y = x.float() * scale[:, None, None] + bias[:, None, None]
    return y.to(x.dtype)


@pytest.mark.parametrize("on_card", [False, True])
def test_peak_memory_is_the_one_expression_forms(on_card, monkeypatch):
    """The counted BatchNorm and pool free each float32 temporary when
    the one-expression forms did, so they hold no more at once."""
    monkeypatch.setattr(fused, "on_card", lambda t: on_card)
    bn = resnet.BatchNorm(16)
    x = torch.randn(4, 16, 12, 12).to(torch.bfloat16)
    for new, old in ((lambda: bn(x), lambda: _old_batch_norm(bn, x)),
                     (lambda: rn_epilogue.avg_pool_plain(x, 2),
                      lambda: F.avg_pool2d(x.float(), 2).to(x.dtype))):
        peaks = []
        for fn in (new, old):
            with torch.no_grad(), fused.counting(Counters()), _LiveBytes() as mode:
                out = fn()
            peaks.append(mode.peak)
            del out
        assert peaks[0] == peaks[1]


def test_spans_only_while_a_profiler_records(monkeypatch):
    model, images = _tower(TINY_RN), _images(TINY_RN, 1)
    calls = []
    real = profiling.annotate
    monkeypatch.setattr(profiling, "annotate", lambda name: calls.append(name) or real(name))
    with torch.no_grad():
        model(images, torch.float32)
    assert calls == []
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof, torch.no_grad():
        model(images, torch.float32)
    assert calls == SPANS
    names = {e.name for e in prof.events()}
    assert set(SPANS) <= names


@pytest.mark.parametrize("compute", ["bfloat16", "float32"])
def test_engine_counts_its_image_encodes(compute, card):
    """The engine's image encodes count into its own ``Counters`` through
    the tower call it already wraps: 3 images run as a bucket of 4; in
    bf16 on the kernels' route, in float32 on the plain one."""
    from evossearch_tpu_torch.core import Config
    from evossearch_tpu_torch.engine import SearchEngine
    from evossearch_tpu_torch.models import CLIP

    cfg = Config(env_path=None)
    cfg.COMPUTE_DTYPE = compute
    module = CLIP(TINY_RN)
    module.visual = _tower(TINY_RN)
    engine = SearchEngine(cfg=cfg, spec=TINY_RN, params=module.eval(), device="cpu")
    try:
        rng = np.random.default_rng(0)
        emb = engine.encode_images([rng.integers(0, 256, (80, 96, 3), np.uint8)
                                    for _ in range(3)])
        assert emb.shape == (3, TINY_RN.embed_dim) and np.isfinite(emb).all()
        got = {k: v for k, v in engine.counters.snapshot().items() if k.startswith("rn_")}
        want = (_fused_counts(TINY_RN, 4) if compute == "bfloat16"
                else _plain_counts(TINY_RN, 4, torch.float32))
        assert got == want
        assert tower.FUSED not in engine.counters.snapshot()
        assert tower.PLAIN_CUDA not in engine.counters.snapshot()
    finally:
        engine.close()


# -- the model before its chains chose their own route, frozen ------------------
# ``models/resnet.py``'s ``_bn_relu``, ``_shortcut_pool``, ``Stem.forward`` and
# ``Bottleneck.forward`` as they were when the model decided each chain's
# route itself; only the route test, then ``rn_epilogue.use_kernel``, and the
# shortcut chain's argument, then its conv output, are spelled in today's names.


def _old_use_kernel(x, *operands):
    return fused.use_kernel(x, x.dtype, *operands, plain=PLAIN)


def _old_bn_relu(bn, x, stride=1):
    if _old_use_kernel(x, *bn.parameters()):
        return rn_epilogue.bn_relu(x, *bn.affine(), stride)
    return rn_epilogue.avg_pool_plain(rn_epilogue.relu_plain(bn(x)), stride)


def _old_shortcut_pool(x, stride):
    if stride != 1 and _old_use_kernel(x):
        return rn_epilogue.avg_pool(x, stride)
    return rn_epilogue.avg_pool_plain(x, stride)


def _old_bn_bn_add_relu(x, scale, shift, y, scale2, shift2):
    return rn_epilogue.bn_bn_add_relu(x, scale, shift, lambda: (y, scale2, shift2))


def _old_bottleneck_forward(self, x, stride):
    out = _old_bn_relu(self.bn1, self.conv1(x))
    out = self.conv3(_old_bn_relu(self.bn2, self.conv2(out), stride))
    ds = self.downsample
    if ds is None:
        if _old_use_kernel(out, x, *self.bn3.parameters()):
            return rn_epilogue.bn_add_relu(out, *self.bn3.affine(), x)
        out = self.bn3(out)
    elif _old_use_kernel(out, x, *self.bn3.parameters(), *ds.bn.parameters()):
        y = ds.conv(_old_shortcut_pool(x, stride))
        return _old_bn_bn_add_relu(out, *self.bn3.affine(), y, *ds.bn.affine())
    else:
        out = self.bn3(out)
        x = ds.bn(ds.conv(_old_shortcut_pool(x, stride)))
    return rn_epilogue.relu_plain(rn_epilogue.add_plain(out, x))


def _old_stem_forward(self, x):
    x = _old_bn_relu(self.bn1, self.conv1(x))
    x = _old_bn_relu(self.bn2, self.conv2(x))
    return _old_bn_relu(self.bn3, self.conv3(x), 2)


def _new_and_old(run):
    """``run()`` with today's model, then with the frozen copy in place."""
    new = run()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(resnet.Stem, "forward", _old_stem_forward)
        mp.setattr(resnet.Bottleneck, "forward", _old_bottleneck_forward)
        return new, run()


class _Ops(TorchDispatchMode):
    """The dispatched aten ops, in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _forward_in(mode, model, images, dtype, grad):
    with torch.set_grad_enabled(grad), fused.counting(Counters()) as c, mode:
        out = model(images, dtype)
    return out.detach(), mode, c.snapshot()


@pytest.mark.parametrize("dtype, grad", ROUTES)
@pytest.mark.parametrize("where", ["tiny_cpu", "rn50_meta"])
def test_plain_route_runs_the_old_models_ops_in_order(where, dtype, grad):
    """The plain route (float32, and bf16 under autograd) dispatches the
    aten ops of the model before its chains chose their own route, in the
    same order: a tiny spec on the CPU (the outputs bit-equal too) and
    RN50 on the meta device."""
    if where == "tiny_cpu":
        model, images = _tower(TINY_RN), _images(TINY_RN, 2)
    else:
        spec = CLIP_MODEL_SPECS["RN50"]
        with torch.device("meta"):
            model = resnet.ModifiedResNet(spec)
        images = torch.empty(2, spec.image_size, spec.image_size, 3, device="meta", dtype=dtype)
    new, old = _new_and_old(lambda: _forward_in(_Ops(), model, images, dtype, grad))
    assert len(new[1].ops) > 300 and new[1].ops == old[1].ops
    if where == "tiny_cpu":
        assert torch.equal(new[0], old[0])


@pytest.mark.parametrize("dtype, grad", ROUTES)
def test_plain_route_holds_the_old_models_peak_of_live_bytes(dtype, grad):
    """The plain route holds the bytes the model before its chains chose
    their own route held, op by op, so at its peak too: each chain frees
    the BatchNorm vectors and the conv output handed over to it where the
    old model freed them."""
    model, images = _tower(TINY_RN), _images(TINY_RN, 3)
    new, old = _new_and_old(lambda: _forward_in(_LiveBytes(), model, images, dtype, grad))
    assert new[1].peak > 0 and new[1].peak == old[1].peak
    assert len(new[1].trace) > 300 and new[1].trace == old[1].trace
    assert torch.equal(new[0], old[0])


@pytest.mark.parametrize("spec, batch", [(TINY_RN, 3), (ODD_RN, 2)])
def test_kernel_route_makes_the_old_models_launches(spec, batch, card, monkeypatch):
    """On the simulated card's kernel route (bf16, nothing recorded) the
    model makes the launches of the model before its chains chose their
    own route, in the same order with the same arguments, and counts the
    same; the outputs are bit-equal."""
    launches = []

    def recording(name, device, args, counter):
        _stand_in(name, device, args, counter)
        launches.append((name, [a.clone() if isinstance(a, torch.Tensor) else a for a in args]))

    monkeypatch.setattr(fused, "launch", recording)
    model, images = _tower(spec), _images(spec, batch)

    def run():
        launches.clear()
        out, _, counts = _forward_in(contextlib.nullcontext(), model, images, torch.bfloat16, False)
        return out, list(launches), counts

    new, old = _new_and_old(run)
    assert torch.equal(new[0], old[0])
    assert new[2] == old[2] == _fused_counts(spec, batch)
    assert [n for n, _ in new[1]] == [n for n, _ in old[1]]
    assert len(new[1]) == expected_fused(spec, batch)[0]
    for (_, got), (_, want) in zip(new[1], old[1]):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            if isinstance(a, torch.Tensor):
                assert (a.dtype, a.shape, a.stride()) == (b.dtype, b.shape, b.stride())
                assert torch.equal(a, b)
            else:
                assert a == b


@pytest.mark.parametrize("on_card", [True, False])
def test_one_device_test_routes_every_kernel_family(on_card, monkeypatch):
    """``fused.on_card`` alone moves the ViT chains and the ResNet chains
    onto the kernels' route (the stand-in launches) or off it: no family
    has a hook of its own."""
    names = []
    monkeypatch.setattr(fused, "on_card", lambda x: on_card)
    monkeypatch.setattr(fused, "launch", lambda name, device, args, counter: names.append(name))
    x = _act()
    with torch.no_grad():
        tower.layer_norm(x.permute(0, 2, 3, 1).contiguous(), torch.ones(16), torch.zeros(16))
        tower.bias_cast(torch.randn(4, 16), torch.zeros(16), torch.bfloat16)
        rn_epilogue.bn_relu(x, torch.ones(16), torch.zeros(16))
        rn_epilogue.avg_pool(x, 2)
    assert names == (["layer_norm", "bias_cast", "rn_bn_relu", "rn_avg_pool"] if on_card else [])
