"""The towers' fused kernels (``ops/csrc/tower_fused.cu``) against their
plain versions on the card: ``bias_cast`` and ``bias_gelu_cast`` bit for
bit, ``layer_norm`` and ``softmax_cast`` within one bf16 ulp, the ViT-L/14
image tower and the text tower fused against plain by cosine, and the
wrappers' refusals.

Imports neither JAX nor the JAX package, so the file also runs on a GPU
machine without them (``python -m pytest --noconftest -m gpu
tests/test_torch_tower_fused.py``). Every test skips in its body where no
CUDA device is present."""

import pytest
import torch

from evossearch_tpu_torch.core import CLIP_MODEL_SPECS
from evossearch_tpu_torch.ops import fused, tower
from evossearch_tpu_torch.utils import Counters

L14 = CLIP_MODEL_SPECS["ViT-L/14"]
BF = torch.bfloat16


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")


def _gen(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


def ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Distance in bf16 steps between two bf16 tensors (+0 and -0 equal)."""
    def ordered(t):
        v = t.contiguous().view(torch.int16).int()
        return torch.where(v >= 0, v, -(v + 32768))
    return (ordered(a) - ordered(b)).abs()


def gemm_like(m: int, n: int, seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    """A float32 (m, n) "GEMM output" and a bias: normal values, one in 7 a
    float whose low 16 bits are 0x8000 (a tie of the bf16 rounding, where the
    bias column is 0), one in 11 large (the GELU's saturated tails), one in
    13 tiny; a zero bias every fifth column."""
    g = _gen(seed)
    y = torch.randn(m, n, generator=g, device="cuda") * 3
    bits = y.view(torch.int32)
    flat = bits.view(-1)
    flat[::7] = (flat[::7] & ~0xFFFF) | 0x8000
    y.view(-1)[::11] *= 40
    y.view(-1)[::13] *= 1e-30
    bias = torch.randn(n, generator=g, device="cuda")
    bias[::5] = 0
    return y, bias


@pytest.mark.gpu
@pytest.mark.parametrize("gelu", [False, True], ids=["bias_cast", "bias_gelu_cast"])
@pytest.mark.parametrize("n", [1024, 3072, 4096])
@pytest.mark.parametrize("m", [512 * 257, 77, 1001])
def test_bias_kernels_bit_equal(m, n, gelu):
    _need_gpu()
    y, bias = gemm_like(m, n, seed=m + n)
    wrapper = tower.bias_gelu_cast if gelu else tower.bias_cast
    plain = tower.bias_gelu_cast_plain if gelu else tower.bias_cast_plain
    with fused.counting(Counters()) as c, torch.no_grad():
        got = wrapper(y, bias, BF)
    want = plain(y, bias, BF)
    torch.cuda.synchronize()
    assert c.snapshot() == {tower.FUSED: 1.0}
    assert got.dtype == BF and got.shape == (m, n)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    # a leading batch dim, as the towers call it
    got3 = wrapper(y.view(1, m, n), bias, BF)
    assert got3.shape == (1, m, n) and torch.equal(got3.view(m, n).view(torch.int16),
                                                   want.view(torch.int16))


@pytest.mark.gpu
@pytest.mark.parametrize("width", [512, 768, 1024])
def test_layer_norm_within_one_ulp(width):
    _need_gpu()
    g = _gen(width)
    rows = 512 * 257 if width == 1024 else 77 * 64 + 3
    x = (torch.randn(rows, width, generator=g, device="cuda") * 2
         + torch.randn(rows, 1, generator=g, device="cuda") * 5).to(BF)
    scale = 1 + torch.randn(width, generator=g, device="cuda") * 0.2
    bias = torch.randn(width, generator=g, device="cuda") * 0.1
    with fused.counting(Counters()) as c:
        got = tower.layer_norm(x, scale, bias)
    want = tower.layer_norm_plain(x, scale, bias)
    torch.cuda.synchronize()
    assert c.snapshot() == {tower.FUSED: 1.0}
    assert got.dtype == BF and got.shape == x.shape
    assert int(ulps(got, want).max()) <= 1


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t, batch, heads", [(257, 32, 16), (77, 48, 12), (20, 5, 3)])
def test_softmax_cast_within_one_ulp(t, batch, heads, causal):
    _need_gpu()
    g = _gen(t)
    logits = torch.randn(batch, heads, t, t, generator=g, device="cuda") * 24
    scale = 64 ** -0.5
    with fused.counting(Counters()) as c:
        got = tower.softmax_cast(logits, scale, causal, BF)
    want = tower.softmax_cast_plain(logits, scale, causal, BF)
    torch.cuda.synchronize()
    assert c.snapshot() == {tower.FUSED: 1.0}
    assert got.dtype == BF and got.shape == logits.shape
    assert int(ulps(got, want).max()) <= 1
    if causal:
        assert not got.float().triu(1).any()


def _towers(model, images, tokens):
    from evossearch_tpu_torch.models import encode_image, encode_text

    return encode_image(model, images, BF), encode_text(model, tokens, BF)


@pytest.mark.gpu
def test_l14_towers_fused_against_plain(monkeypatch):
    """ViT-L/14's image tower at batch 64 and its text tower at batch 8,
    fused against plain: 1 - cosine <= 2e-5 per row."""
    _need_gpu()
    from evossearch_tpu_torch.models import CLIP

    model = CLIP(L14).init_random_(torch.Generator().manual_seed(14)).cuda().eval()
    g = _gen(15)
    images = torch.randn(64, L14.image_size, L14.image_size, 3, generator=g, device="cuda")
    tokens = torch.randint(1, 49000, (8, L14.context_length), generator=g, device="cuda")
    tokens[:, 20:] = 0
    tokens[:, 19] = 49407
    with fused.counting(Counters()) as c:
        kernels = _towers(model, images, tokens)
    chains = 7 * (L14.vision_layers + L14.text_layers) + 3
    assert c.snapshot() == {tower.FUSED: float(chains)}
    monkeypatch.setattr(fused, "on_card", lambda x: False)
    plain = _towers(model, images, tokens)
    for f, p in zip(kernels, plain):
        gap = 1 - (f.double() * p.double()).sum(-1)
        assert float(gap.max()) <= 2e-5, float(gap.max())


@pytest.mark.gpu
def test_wrappers_refuse_what_the_kernels_do_not_take():
    _need_gpu()
    g = _gen(9)
    y = torch.randn(64, 256, generator=g, device="cuda")
    b = torch.randn(256, generator=g, device="cuda")
    x = y.to(BF)
    logits = torch.randn(2, 4, 9, 9, generator=g, device="cuda")
    with torch.no_grad():
        for fn in (tower.bias_cast, tower.bias_gelu_cast):
            with pytest.raises(ValueError, match="contiguous"):
                fn(y[:, :128].t(), b[:64], BF)
            with pytest.raises(ValueError, match="aligned"):
                fn(y.view(-1)[1:1 + 63 * 256].view(63, 256), b, BF)
            with pytest.raises(ValueError, match="float32"):
                fn(x, b, BF)
        with pytest.raises(ValueError, match="contiguous"):
            tower.layer_norm(x[:, :128].t(), b[:64], b[:64])
        with pytest.raises(ValueError, match="aligned"):
            tower.layer_norm(x.view(-1)[1:1 + 63 * 256].view(63, 256), b, b)
        with pytest.raises(ValueError, match="contiguous"):
            tower.softmax_cast(logits.transpose(-1, -2), 0.125, False, BF)
        with pytest.raises(ValueError, match="aligned"):
            tower.softmax_cast(logits.view(-1)[1:1 + 81].view(1, 9, 9), 0.125, False, BF)
        with pytest.raises(ValueError, match="float32"):
            tower.softmax_cast(logits.to(BF), 0.125, False, BF)
    # the kernels' own shape checks, under the wrapper's
    from evossearch_tpu_torch.ops._build import entry

    out = torch.empty(64, 12, dtype=BF, device="cuda")
    rc = entry("bias_cast")(y.data_ptr(), b.data_ptr(), out.data_ptr(), 64, 12,
                            torch.cuda.current_stream().cuda_stream)
    assert rc != 0  # width 12 is not a multiple of 8
