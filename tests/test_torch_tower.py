"""``ops/tower.py`` on the CPU: its plain versions against the towers'
code before the chains moved there, the dispatch between the fused kernels
and the plain versions (the CPU, the float32 compute dtype and autograd
take the plain version, and the counters say so), the wrappers' argument
checks and plumbing on a simulated card, training's loss and gradients,
and an import without nvcc. The kernels themselves run on the card:
``tests/test_torch_tower_fused.py``."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from evossearch_tpu_torch.core import CLIP_MODEL_SPECS
from evossearch_tpu_torch.models import CLIP, encode_image, encode_text, layers
from evossearch_tpu_torch.ops import _build, fused, tower
from evossearch_tpu_torch.train.contrastive import clip_loss
from evossearch_tpu_torch.utils import Counters

ROOT = Path(__file__).resolve().parents[1]
TINY = dataclasses.replace(
    CLIP_MODEL_SPECS["ViT-B/32"], name="tiny", image_size=64, patch_size=16,
    vision_width=64, vision_layers=2, vision_heads=4, text_width=48,
    text_layers=2, text_heads=4, embed_dim=32, context_length=16,
)
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


# -- the towers' code before the move (models/layers.py), verbatim ------------


def _old_quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def _old_dense_epilogue(y, bias, dtype):
    y = y + bias.float()
    return y.to(dtype)


def _old_layer_norm(x, scale, bias):
    dtype = x.dtype
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + 1e-5)
    return (y * scale.float() + bias.float()).to(dtype)


def _old_softmax(logits, hd, causal, dtype):
    t = logits.shape[-2]
    logits = logits * (hd ** -0.5)
    if causal:
        keep = torch.ones(t, t, dtype=torch.bool, device=logits.device).tril()
        logits = logits.masked_fill(~keep, torch.finfo(torch.float32).min)
    return torch.softmax(logits, dim=-1).to(dtype)


class _OldTower:
    """``layers.tower`` as the towers computed it before the move."""

    bias_cast = staticmethod(_old_dense_epilogue)

    @staticmethod
    def bias_gelu_cast(y, bias, dtype):
        return _old_quick_gelu(_old_dense_epilogue(y, bias, dtype))

    layer_norm = staticmethod(_old_layer_norm)

    @staticmethod
    def softmax_cast(logits, scale, causal, dtype):
        return _old_softmax(logits, round(scale ** -2), causal, dtype)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _model(seed=0):
    return CLIP(TINY).init_random_(_gen(seed)).eval()


def _inputs(seed=1, batch=3):
    g = _gen(seed)
    images = torch.randn(batch, TINY.image_size, TINY.image_size, 3, generator=g)
    tokens = torch.randint(1, 400, (batch, TINY.context_length), generator=g)
    tokens[:, -1] = 49407  # EOT, the highest id
    return images, tokens


# -- the plain versions ---------------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("gelu", [False, True], ids=["bias_cast", "bias_gelu_cast"])
def test_plain_bias_chains_equal_the_old_code(gelu, dtype):
    g = _gen(2)
    y, b = torch.randn(2, 17, 96, generator=g) * 3, torch.randn(96, generator=g)
    want = _old_dense_epilogue(y, b, DTYPES[dtype])
    if gelu:
        want = _old_quick_gelu(want)
        got = tower.bias_gelu_cast_plain(y, b, DTYPES[dtype])
    else:
        got = tower.bias_cast_plain(y, b, DTYPES[dtype])
    assert got.dtype == DTYPES[dtype] and torch.equal(got, want)
    assert torch.equal(tower.quick_gelu(y), _old_quick_gelu(y))
    assert layers.quick_gelu is tower.quick_gelu


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("biased", [False, True], ids=["no_bias", "bias"])
@pytest.mark.parametrize("gelu", [False, True], ids=["dense", "dense_gelu"])
def test_dense_equals_the_old_code(gelu, biased, dtype):
    """``_dense`` (with its quick-GELU epilogue: the MLP's first product)
    gives what the old dense layer, then ``quick_gelu``, gave."""
    g = _gen(6)
    x = torch.randn(2, 7, 64, generator=g).to(DTYPES[dtype])
    w, b = torch.randn(64, 96, generator=g), torch.randn(96, generator=g) if biased else None
    y = layers.matmul_f32(x, w.to(x.dtype))
    want = _old_dense_epilogue(y, b, x.dtype) if biased else y.to(x.dtype)
    if gelu:
        want = _old_quick_gelu(want)
    got = layers._dense(x, w, b, gelu=gelu)
    assert got.dtype == x.dtype and torch.equal(got, want)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("width", [48, 64, 768])
def test_plain_layer_norm_equals_the_old_code(width, dtype):
    g = _gen(3)
    x = (torch.randn(2, 9, width, generator=g) * 4 + 1).to(DTYPES[dtype])
    scale, bias = torch.randn(width, generator=g), torch.randn(width, generator=g)
    got = tower.layer_norm_plain(x, scale, bias)
    assert got.dtype == DTYPES[dtype] and torch.equal(got, _old_layer_norm(x, scale, bias))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", [5, 17, 77])
def test_plain_softmax_cast_equals_the_old_code(t, causal, dtype):
    g = _gen(4)
    logits = torch.randn(2, 3, t, t, generator=g) * 20
    got = tower.softmax_cast_plain(logits, 64 ** -0.5, causal, DTYPES[dtype])
    want = _old_softmax(logits, 64, causal, DTYPES[dtype])
    assert got.dtype == DTYPES[dtype] and torch.equal(got, want)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_towers_equal_the_old_code(dtype, monkeypatch):
    """Both towers through ``layers`` give what they gave before the move,
    bit for bit."""
    model, (images, tokens) = _model(), _inputs()
    got = (encode_image(model, images, DTYPES[dtype]), encode_text(model, tokens, DTYPES[dtype]))
    monkeypatch.setattr(layers, "tower", _OldTower)
    want = (encode_image(model, images, DTYPES[dtype]), encode_text(model, tokens, DTYPES[dtype]))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# -- the dispatch -----------------------------------------------------------------


def _fake_launch(name, device, args, counter):
    """The kernels' entry points computed by their plain versions from the
    arguments the wrappers pass (rows, widths, scale, causal flag), writing
    into the wrapper's output as a kernel would, counted as
    ``fused.launch`` counts."""
    assert counter == tower.FUSED
    if name in ("bias_cast", "bias_gelu_cast"):
        y, bias, out, m, n = args
        plain = tower.bias_cast_plain if name == "bias_cast" else tower.bias_gelu_cast_plain
        out.view(m, n).copy_(plain(y.view(m, n), bias, torch.bfloat16))
    elif name == "layer_norm":
        x, scale, bias, out, rows, w, factor, eps = args
        assert eps == tower.LN_EPS and factor == float(np.float32(rows) / np.float32(rows * w))
        out.view(rows, w).copy_(tower.layer_norm_plain(x.view(rows, w), scale, bias))
    else:
        assert name == "softmax_cast"
        logits, out, rows, t, scale, causal = args
        assert rows % t == 0 and causal in (0, 1)
        out.view(-1, t, t).copy_(tower.softmax_cast_plain(
            logits.view(-1, t, t), scale, bool(causal), torch.bfloat16))
    fused.count(counter)


@pytest.fixture
def card(monkeypatch):
    """Every tensor counts as on the card; launches run ``_fake_launch``."""
    monkeypatch.setattr(fused, "on_card", lambda x: True)
    monkeypatch.setattr(fused, "launch", _fake_launch)


def _no_build(*args, **kwargs):
    raise AssertionError("the CPU route must not build or load a kernel")


def _calls():
    g = _gen(5)
    y, b = torch.randn(4, 3, 64, generator=g), torch.randn(64, generator=g)
    x, s = torch.randn(4, 3, 64, generator=g).to(torch.bfloat16), torch.randn(64, generator=g)
    logits = torch.randn(2, 4, 7, 7, generator=g)
    return {
        "bias_cast": (lambda d: tower.bias_cast(y, b, d),
                      lambda d: tower.bias_cast_plain(y, b, d)),
        "bias_gelu_cast": (lambda d: tower.bias_gelu_cast(y, b, d),
                           lambda d: tower.bias_gelu_cast_plain(y, b, d)),
        "layer_norm": (lambda d: tower.layer_norm(x.to(d), s, b),
                       lambda d: tower.layer_norm_plain(x.to(d), s, b)),
        "softmax_cast": (lambda d: tower.softmax_cast(logits, 0.125, True, d),
                         lambda d: tower.softmax_cast_plain(logits, 0.125, True, d)),
    }


@pytest.mark.parametrize("name", sorted(_calls()))
def test_cpu_tensors_take_the_plain_version(name, monkeypatch):
    monkeypatch.setattr(_build, "entry", _no_build)
    wrapper, plain = _calls()[name]
    with fused.counting(Counters()) as counters:
        for dtype in DTYPES.values():
            assert torch.equal(wrapper(dtype), plain(dtype))
    assert counters.snapshot() == {}


@pytest.mark.parametrize("name", sorted(_calls()))
def test_card_route_by_compute_dtype_and_autograd(name, card):
    """On the card: bf16 with nothing recorded launches; float32, and bf16
    under autograd, take the plain version and count it."""
    wrapper, plain = _calls()[name]
    c = Counters()
    with fused.counting(c), torch.no_grad():
        assert torch.equal(wrapper(torch.bfloat16), plain(torch.bfloat16))
    assert c.snapshot() == {tower.FUSED: 1.0}
    with fused.counting(c):
        assert torch.equal(wrapper(torch.float32), plain(torch.float32))
    assert c.snapshot() == {tower.FUSED: 1.0, tower.PLAIN_CUDA: 1.0}
    with fused.counting(c):  # grad mode on, but no operand requires grad
        assert torch.equal(wrapper(torch.bfloat16), plain(torch.bfloat16))
    assert c.snapshot() == {tower.FUSED: 2.0, tower.PLAIN_CUDA: 1.0}
    model = _model()
    with fused.counting(c):
        block = model.visual.blocks[0]
        x = torch.randn(2, 5, TINY.vision_width).to(torch.bfloat16)
        out = {"bias_cast": lambda: layers._dense(x, block.attn.wo, block.attn.bo),
               "bias_gelu_cast": lambda: block.mlp(x),
               "layer_norm": lambda: block.ln_1(x),
               "softmax_cast": lambda: block.attn(x)}[name]()
    assert out.requires_grad and out.dtype == torch.bfloat16
    assert c.snapshot()[tower.FUSED] == 2.0 and c.snapshot()[tower.PLAIN_CUDA] > 1.0
    before = c.snapshot()
    fused.count(tower.FUSED)  # outside ``counting``: the sink is gone
    assert c.snapshot() == before


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_simulated_card_towers_equal_the_cpu_towers(dtype, card):
    """The towers through the wrappers' kernel route (arguments computed by
    the plain versions) equal the plain towers; bf16 launches once per
    chain (7 a block, and ln_pre + ln_post or ln_final), float32 launches
    nothing and counts each chain as a plain call on the card."""
    model, (images, tokens) = _model(), _inputs()
    with fused.counting(Counters()) as c:
        got_img = encode_image(model, images, DTYPES[dtype])
        got_txt = encode_text(model, tokens, DTYPES[dtype])
    chains = 7 * (TINY.vision_layers + TINY.text_layers) + 3
    key = tower.FUSED if dtype == "bf16" else tower.PLAIN_CUDA
    assert c.snapshot() == {key: float(chains)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fused, "on_card", lambda x: False)
        want_img = encode_image(model, images, DTYPES[dtype])
        want_txt = encode_text(model, tokens, DTYPES[dtype])
    assert torch.equal(got_img, want_img) and torch.equal(got_txt, want_txt)


def test_wrappers_raise_on_what_the_kernel_does_not_take(card):
    g = _gen(6)
    y = torch.randn(8, 64, generator=g)
    b = torch.randn(64, generator=g)
    x = y.to(torch.bfloat16)
    logits = torch.randn(2, 9, 9, generator=g)
    bf = torch.bfloat16
    with torch.no_grad():
        for fn in (tower.bias_cast, tower.bias_gelu_cast):
            with pytest.raises(ValueError, match="contiguous"):
                fn(y.t(), torch.randn(8), bf)
            with pytest.raises(ValueError, match="aligned"):
                fn(torch.randn(8 * 64 + 1, generator=g)[1:].view(8, 64), b, bf)
            with pytest.raises(ValueError, match="float32"):
                fn(x, b, bf)
            with pytest.raises(ValueError, match="multiple of 8"):
                fn(y[:, :60].contiguous(), b[:60], bf)
            with pytest.raises(ValueError, match="bias shape"):
                fn(y, b[:32], bf)
        with pytest.raises(ValueError, match="contiguous"):
            tower.layer_norm(x.t(), torch.ones(8), torch.zeros(8))
        with pytest.raises(ValueError, match="aligned"):
            tower.layer_norm(torch.randn(8 * 64 + 1).to(bf)[1:].view(8, 64), b, b)
        with pytest.raises(ValueError, match="multiple of 4"):
            tower.layer_norm(x[:, :62].contiguous(), b[:62], b[:62])
        with pytest.raises(ValueError, match="up to 2048"):
            tower.layer_norm(torch.zeros(2, 2056, dtype=bf), torch.ones(2056), torch.ones(2056))
        with pytest.raises(ValueError, match="scale shape"):
            tower.layer_norm(x, b[:32], b)
        with pytest.raises(ValueError, match="contiguous"):
            tower.softmax_cast(logits.transpose(-1, -2), 0.125, False, bf)
        with pytest.raises(ValueError, match="aligned"):
            tower.softmax_cast(torch.randn(2 * 81 + 1)[1:].view(2, 9, 9), 0.125, False, bf)
        with pytest.raises(ValueError, match="float32"):
            tower.softmax_cast(logits.to(bf), 0.125, False, bf)
        with pytest.raises(ValueError, match="T <= 1024"):
            tower.softmax_cast(torch.zeros(1, 1025, 1025), 0.125, False, bf)
        with pytest.raises(ValueError, match=r"\(\.\.\., T, T\)"):
            tower.softmax_cast(torch.zeros(2, 9, 8), 0.125, False, bf)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_training_loss_and_gradients_unchanged(dtype, card):
    """``clip_loss`` and every gradient, on the simulated card (autograd
    records, so every chain takes the plain version and counts it) and on
    the CPU, equal the towers' code before the move, bit for bit."""
    images, tokens = _inputs(7, batch=4)

    def loss_and_grads(model):
        loss = clip_loss(model, images, tokens, DTYPES[dtype], remat=False)
        loss.backward()
        return loss.detach(), {n: p.grad for n, p in model.named_parameters()}

    with fused.counting(Counters()) as c:
        got = loss_and_grads(_model(8))
    snap = c.snapshot()
    assert tower.FUSED not in snap and snap[tower.PLAIN_CUDA] > 0
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fused, "on_card", lambda x: False)
        cpu = loss_and_grads(_model(8))
        mp.setattr(layers, "tower", _OldTower)
        old = loss_and_grads(_model(8))
    for other in (cpu, old):
        assert torch.equal(got[0], other[0])
        assert all((g is None and other[1][n] is None) or torch.equal(g, other[1][n])
                   for n, g in got[1].items())
    assert all(g is not None for n, g in got[1].items() if not n.startswith("logit"))


def test_engine_counts_its_tower_calls(card):
    """The engine's encodes count into its own ``Counters``: one launch per
    chain of a text encode; none on the CPU."""
    from evossearch_tpu_torch.core import Config
    from evossearch_tpu_torch.engine import SearchEngine

    cfg = Config(env_path=None)
    cfg.COMPUTE_DTYPE = "bfloat16"
    engine = SearchEngine(cfg=cfg, spec=TINY, params=_model(), device="cpu")
    try:
        engine.encode_text("a red car")
        assert engine.counters.snapshot()[tower.FUSED] == 7 * TINY.text_layers + 1
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(fused, "on_card", lambda x: False)
            engine.encode_text("a blue car")
        assert engine.counters.snapshot()[tower.FUSED] == 7 * TINY.text_layers + 1
        assert tower.PLAIN_CUDA not in engine.counters.snapshot()
    finally:
        engine.close()


def test_imports_and_runs_on_the_cpu_without_nvcc(tmp_path):
    """The module imports, and the towers run their plain versions, with no
    CUDA toolkit in reach; nothing is built or loaded."""
    env = {k: v for k, v in os.environ.items() if k not in ("CUDA_HOME", "CUDA_PATH")}
    env["PATH"] = str(tmp_path)  # no nvcc on it
    env["PYTHONPATH"] = str(ROOT)
    code = (
        "import torch\n"
        "from evossearch_tpu_torch.ops import _build, tower\n"
        "y = tower.bias_cast(torch.ones(2, 8), torch.ones(8), torch.bfloat16)\n"
        "assert y.dtype == torch.bfloat16 and bool((y == 2).all())\n"
        "assert tower.layer_norm(torch.ones(2, 8, dtype=torch.bfloat16), torch.ones(8),"
        " torch.zeros(8)).abs().max() == 0\n"
        "assert _build._loaded == {} and _build.BUILD_LOG == {}\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
