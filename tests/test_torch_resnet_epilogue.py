"""The modified ResNet's conv epilogue counters and spans
(``evossearch_tpu_torch/models/resnet.py``): ``rn_epilogue_passes`` and
``rn_epilogue_bytes`` against a count worked from the shapes alone, at a
tiny spec on the CPU and at RN50 and RN50x64 on the meta device (no
memory, no arithmetic); nothing counted on CPU tensors or outside
``ops.tower.counting``; the tower's output bit-equal with counting on and
off; the stem, stage and attention-pool spans only while a profiler
records; and the engine's image encodes counting into its ``Counters``.

A simulated card (``tower._on_card`` patched to True) stands in for a
CUDA device, as in ``tests/test_torch_tower.py``."""

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
from evossearch_tpu_torch.ops import tower
from evossearch_tpu_torch.utils import profiling
from evossearch_tpu_torch.utils.logging import Counters

PASSES, BYTES = resnet.EPILOGUE_PASSES, resnet.EPILOGUE_BYTES

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
    """Every tensor counts as on the card."""
    monkeypatch.setattr(tower, "_on_card", lambda x: True)


def _count(model, images, dtype):
    counters = Counters()
    with torch.no_grad(), tower.counting(counters):
        out = model(images, dtype)
    return out, counters.snapshot()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("spec, batch", [(TINY_RN, 3), (ODD_RN, 2)])
def test_counts_equal_the_shapes(spec, batch, dtype, card):
    _, got = _count(_tower(spec), _images(spec, batch), dtype)
    passes, nbytes = expected_epilogue(spec, batch, dtype)
    assert got == {PASSES: passes, BYTES: nbytes}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name, batch", [("RN50", 4), ("RN50x64", 2)])
def test_counts_equal_the_shapes_at_published_widths(name, batch, dtype, card):
    """Full-size towers on the meta device: shapes only."""
    spec = CLIP_MODEL_SPECS[name]
    with torch.device("meta"):
        model = resnet.ModifiedResNet(spec)
    images = torch.empty(batch, spec.image_size, spec.image_size, 3, device="meta", dtype=dtype)
    out, got = _count(model, images, dtype)
    assert out.shape == (batch, spec.embed_dim)
    assert got == dict(zip((PASSES, BYTES), expected_epilogue(spec, batch, dtype)))


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
    model, images = _tower(TINY_RN), _images(TINY_RN, 2)
    counters = Counters()
    with tower.counting(counters):
        pass
    with torch.no_grad():
        model(images, torch.bfloat16)
    assert counters.snapshot() == {}
    _, got = _count(model, images, torch.bfloat16)
    assert got[PASSES] == expected_epilogue(TINY_RN, 2, torch.bfloat16)[0]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_output_bit_equal_with_counting_on_and_off(dtype, monkeypatch):
    model, images = _tower(TINY_RN), _images(TINY_RN, 3)
    with torch.no_grad():
        plain = model(images, dtype)
    monkeypatch.setattr(tower, "_on_card", lambda x: True)
    counted, got = _count(model, images, dtype)
    assert got[PASSES] > 0
    assert torch.equal(counted, plain)


def test_counting_launches_the_same_ops_in_the_same_order(monkeypatch):
    """The dispatched aten ops, in order, are those of the tower before
    the counters: BatchNorm's affine as cast, mul, add, cast."""
    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    bn = resnet.BatchNorm(8)
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in (bn.scale, bn.bias, bn.mean):
            p.copy_(torch.randn(8, generator=g))
        bn.var.copy_(torch.rand(8, generator=g) + 0.5)
    x = torch.randn(2, 8, 5, 5, generator=g).to(torch.bfloat16)
    runs = []
    for on_card in (False, True):
        monkeypatch.setattr(tower, "_on_card", lambda t, on=on_card: on)
        with torch.no_grad(), tower.counting(Counters()), Ops() as mode:
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
    """The most bytes held at once by the storages of tensors that ops
    made inside the mode (a view adds none), read as each op returns."""

    def __init__(self):
        super().__init__()
        self.refs, self.peak = [], 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.refs += [weakref.ref(t) for t in (out if isinstance(out, tuple) else (out,))
                      if isinstance(t, torch.Tensor)]
        live = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in (r() for r in self.refs) if t is not None}
        self.peak = max(self.peak, sum(live.values()))
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
    monkeypatch.setattr(tower, "_on_card", lambda t: on_card)
    bn = resnet.BatchNorm(16)
    x = torch.randn(4, 16, 12, 12).to(torch.bfloat16)
    for new, old in ((lambda: bn(x), lambda: _old_batch_norm(bn, x)),
                     (lambda: resnet._avg_pool(x, 2),
                      lambda: F.avg_pool2d(x.float(), 2).to(x.dtype))):
        peaks = []
        for fn in (new, old):
            with torch.no_grad(), tower.counting(Counters()), _LiveBytes() as mode:
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


def test_engine_counts_its_image_encodes(card):
    """The engine's image encodes count into its own ``Counters`` through
    the tower call it already wraps: 3 images run as a bucket of 4."""
    from evossearch_tpu_torch.core import Config
    from evossearch_tpu_torch.engine import SearchEngine
    from evossearch_tpu_torch.models import CLIP

    cfg = Config(env_path=None)
    cfg.COMPUTE_DTYPE = "bfloat16"
    module = CLIP(TINY_RN)
    module.visual = _tower(TINY_RN)
    engine = SearchEngine(cfg=cfg, spec=TINY_RN, params=module.eval(), device="cpu")
    try:
        rng = np.random.default_rng(0)
        emb = engine.encode_images([rng.integers(0, 256, (80, 96, 3), np.uint8)
                                    for _ in range(3)])
        assert emb.shape == (3, TINY_RN.embed_dim) and np.isfinite(emb).all()
        got = engine.counters.snapshot()
        assert (got[PASSES], got[BYTES]) == expected_epilogue(TINY_RN, 4, torch.bfloat16)
        assert tower.FUSED not in got and tower.PLAIN_CUDA not in got
    finally:
        engine.close()
