"""The port's modified-ResNet image tower against the JAX package's, on the
CPU: the same param pytree (random BatchNorm statistics and gammas, so no
residual branch vanishes) through ``params_from_numpy``, the same images;
f32 within the tolerance the JAX package holds itself to against its torch
oracle (tests/test_resnet.py), bf16 against f32 by cosine. Then the
converter path from an OpenAI-layout state dict, the init and its count,
the npz round trip, and an engine on a ResNet checkpoint."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from evossearch_tpu.core import CLIPResNetSpec as RefSpec
from evossearch_tpu.models import encode_image as ref_encode_image
from evossearch_tpu.models import expected_param_count as ref_expected_param_count
from evossearch_tpu.models import load_checkpoint as ref_load_checkpoint
from evossearch_tpu.models.checkpoint import load_params as ref_load_params
from evossearch_tpu.models.checkpoint import save_params as ref_save_params
from evossearch_tpu.models.resnet import encode_image_resnet
from evossearch_tpu_torch.core import CLIP_MODEL_SPECS, Config
from evossearch_tpu_torch.core.constants import CLIPResNetSpec
from evossearch_tpu_torch.engine import SearchEngine
from evossearch_tpu_torch.models import (
    CLIP,
    encode_image,
    expected_param_count,
    from_openai_state_dict,
    load_checkpoint,
    load_model,
    load_params,
    params_from_numpy,
    save_params,
)
from evossearch_tpu_torch.models import resnet

ATOL, RTOL = 2e-5, 1e-4  # the JAX package's own, against its torch oracle
BF16_COS = 0.995  # tests/test_resnet.py's bf16 rule

# tests/test_resnet.py's tiny spec: multi-block AND single-block stages,
# 64 px -> a 2x2 final grid, attn_dim 512, 8 attention-pool heads
TINY_RN = CLIPResNetSpec(
    name="tiny-rn", image_size=64,
    vision_width=16, vision_layers=(2, 1, 1, 2), vision_heads=8,
    text_width=48, text_layers=2, text_heads=4,
    vocab_size=512, context_length=16, embed_dim=32,
)


def _ref_spec(spec):
    return RefSpec(**dataclasses.asdict(spec))


def _params(spec, seed=0):
    """A seeded OpenAI-layout state dict for ``spec`` (random BatchNorm
    statistics and gammas), converted to the JAX package's param pytree
    by the port's converter (array-equal to the JAX package's:
    tests/test_torch_convert.py)."""
    return from_openai_state_dict(_openai_resnet_sd(spec, seed, spec.text_width))[0]


def count_params(model) -> int:
    return sum(p.numel() for p in model.parameters())


def _images(spec, n=3, seed=42):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, spec.image_size, spec.image_size, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def tiny():
    params = _params(TINY_RN)
    return params, params_from_numpy(params, TINY_RN, "cpu")


def test_tower_matches_reference_f32(tiny):
    params, model = tiny
    images = _images(TINY_RN)
    want = np.asarray(encode_image_resnet(params, jnp.asarray(images), _ref_spec(TINY_RN)))
    got = encode_image(model, torch.from_numpy(images)).numpy()
    assert got.shape == (3, TINY_RN.embed_dim)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # the unnormalized output is the attention pool's, not a unit row
    raw = encode_image(model, torch.from_numpy(images), normalize=False).numpy()
    np.testing.assert_allclose(raw / np.linalg.norm(raw, axis=1, keepdims=True), got,
                               atol=1e-6)


def test_bf16_close_to_f32(tiny):
    _, model = tiny
    images = torch.from_numpy(_images(TINY_RN))
    f32 = encode_image(model, images).numpy()
    bf16 = encode_image(model, images, torch.bfloat16).numpy()
    assert ((f32 * bf16).sum(-1) > BF16_COS).all()


def test_f32_forward_turns_cudnn_tf32_off_and_restores_it(tiny, monkeypatch):
    """f32 convs run at full precision: cuDNN's TF32 flag is off inside an
    f32 forward, untouched in a bf16 one, and restored after."""
    _, model = tiny
    seen = []
    forward = resnet.Conv.forward

    def spy(self, x):
        seen.append((x.dtype, torch.backends.cudnn.allow_tf32))
        return forward(self, x)

    monkeypatch.setattr(resnet.Conv, "forward", spy)
    before = torch.backends.cudnn.allow_tf32
    images = torch.from_numpy(_images(TINY_RN, n=1))
    encode_image(model, images)
    assert seen and all(flag is False for dtype, flag in seen if dtype == torch.float32)
    assert torch.backends.cudnn.allow_tf32 == before
    seen.clear()
    encode_image(model, images, torch.bfloat16)
    assert seen and all(flag == before for _, flag in seen)
    with resnet.full_f32_convs():  # nested scopes restore once, at the last exit
        with resnet.full_f32_convs():
            assert torch.backends.cudnn.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 == before


def test_rn101_depth_stage_matches_reference():
    """RN101's stage depths (3, 4, 23, 3) at narrow width: the 22-block
    tail of stage 3 unstacked block by block in the JAX order."""
    deep = dataclasses.replace(TINY_RN, name="tiny-rn101", vision_layers=(3, 4, 23, 3))
    params = _params(deep, seed=11)
    assert params["visual"]["stage3"]["rest"]["conv1"]["kernel"].shape[0] == 22
    model = params_from_numpy(params, deep, "cpu")
    assert len(model.visual.stage3.rest) == 22
    images = _images(deep, n=2, seed=13)
    want = np.asarray(encode_image_resnet(params, jnp.asarray(images), _ref_spec(deep)))
    got = encode_image(model, torch.from_numpy(images)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=5e-5)


def test_params_from_numpy_maps_every_leaf(tiny):
    """Every leaf of the JAX tree lands on one parameter, unstacked where
    the JAX package stacks a stage's tail; none is left over."""
    params, model = tiny
    state = {k: v for k, v in model.state_dict().items() if k.startswith("visual.")}
    flat = {}

    def walk(tree, prefix):
        for key, value in tree.items():
            name = f"{prefix}.{key}"
            if isinstance(value, dict):
                walk(value, name)
            elif ".rest." in name:
                for b in range(value.shape[0]):
                    flat[name.replace(".rest.", f".rest.{b}.", 1)] = value[b]
            else:
                flat[name] = value

    walk(params["visual"], "visual")
    assert set(flat) == set(state)
    for name, value in flat.items():
        np.testing.assert_array_equal(state[name].numpy(), np.asarray(value, np.float32))
    assert "rest" not in params["visual"]["stage2"]  # a one-block stage
    assert len(model.visual.stage2.rest) == 0


def _openai_resnet_sd(spec, seed: int, tw: int = 64) -> dict:
    """A seeded state dict in OpenAI's clip/model.py ModifiedResNet layout
    with random BN statistics and gammas (OpenAI's zero bn3 init would
    make every residual branch vanish), plus a ``tw``-wide text tower (64
    by default, so the converter's inferred heads, width // 64, are
    valid)."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}

    def t(key, *shape, std=1.0):
        sd[key] = std * torch.randn(*shape, generator=gen)

    def bn(prefix, c):
        t(f"{prefix}.weight", c, std=0.2)
        sd[f"{prefix}.weight"] += 1.0
        t(f"{prefix}.bias", c, std=0.1)
        t(f"{prefix}.running_mean", c, std=0.2)
        sd[f"{prefix}.running_var"] = 0.5 + torch.rand(c, generator=gen)
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)

    w = spec.vision_width
    for i, (cin, cout) in enumerate(((3, w // 2), (w // 2, w // 2), (w // 2, w))):
        t(f"visual.conv{i + 1}.weight", cout, cin, 3, 3, std=(9 * cin) ** -0.5)
        bn(f"visual.bn{i + 1}", cout)
    inplanes = w
    for stage, blocks in enumerate(spec.vision_layers):
        planes = w * 2 ** stage
        for j in range(blocks):
            p = f"visual.layer{stage + 1}.{j}"
            t(f"{p}.conv1.weight", planes, inplanes, 1, 1, std=inplanes ** -0.5)
            bn(f"{p}.bn1", planes)
            t(f"{p}.conv2.weight", planes, planes, 3, 3, std=(9 * planes) ** -0.5)
            bn(f"{p}.bn2", planes)
            t(f"{p}.conv3.weight", planes * 4, planes, 1, 1, std=planes ** -0.5)
            bn(f"{p}.bn3", planes * 4)
            if j == 0:
                t(f"{p}.downsample.0.weight", planes * 4, inplanes, 1, 1,
                  std=inplanes ** -0.5)
                bn(f"{p}.downsample.1", planes * 4)
            inplanes = planes * 4
    c = spec.attn_dim
    t("visual.attnpool.positional_embedding", spec.num_image_tokens, c, std=c ** -0.5)
    for proj in ("q_proj", "k_proj", "v_proj"):
        t(f"visual.attnpool.{proj}.weight", c, c, std=c ** -0.5)
        t(f"visual.attnpool.{proj}.bias", c, std=0.02)
    t("visual.attnpool.c_proj.weight", spec.embed_dim, c, std=c ** -0.5)
    t("visual.attnpool.c_proj.bias", spec.embed_dim, std=0.02)
    t("token_embedding.weight", spec.vocab_size, tw, std=0.02)
    t("positional_embedding", spec.context_length, tw, std=0.01)
    t("ln_final.weight", tw)
    t("ln_final.bias", tw)
    t("text_projection", tw, spec.embed_dim, std=tw ** -0.5)
    sd["logit_scale"] = torch.tensor(4.6052)
    for i in range(spec.text_layers):
        p = f"transformer.resblocks.{i}"
        for ln in ("ln_1", "ln_2"):
            t(f"{p}.{ln}.weight", tw)
            t(f"{p}.{ln}.bias", tw)
        t(f"{p}.attn.in_proj_weight", 3 * tw, tw, std=tw ** -0.5)
        t(f"{p}.attn.in_proj_bias", 3 * tw, std=0.02)
        t(f"{p}.attn.out_proj.weight", tw, tw, std=tw ** -0.5)
        t(f"{p}.attn.out_proj.bias", tw, std=0.02)
        t(f"{p}.mlp.c_fc.weight", 4 * tw, tw, std=tw ** -0.5)
        t(f"{p}.mlp.c_fc.bias", 4 * tw, std=0.02)
        t(f"{p}.mlp.c_proj.weight", tw, 4 * tw, std=(4 * tw) ** -0.5)
        t(f"{p}.mlp.c_proj.bias", tw, std=0.02)
    return sd


def test_openai_checkpoint_through_load_checkpoint_matches_reference(tmp_path):
    """An OpenAI-layout ResNet ``.pt`` through each package's
    load_checkpoint: the port's tower equals the JAX package's on it."""
    path = tmp_path / "rn.pt"
    torch.save(_openai_resnet_sd(TINY_RN, seed=5), path)
    tree, spec = load_checkpoint(str(path))
    ref_tree, ref_spec = ref_load_checkpoint(str(path))
    assert spec.family == "resnet" and spec.vision_layers == TINY_RN.vision_layers
    assert dataclasses.asdict(spec) == dataclasses.asdict(ref_spec)
    model = params_from_numpy(tree, spec, "cpu")
    images = _images(spec, n=2, seed=6)
    want = np.asarray(ref_encode_image(ref_tree, jnp.asarray(images), ref_spec))
    got = encode_image(model, torch.from_numpy(images)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_init_matches_analytic_count_for_every_resnet_spec():
    """A real init of the tiny spec, and the module built for every RN*
    release spec (on the meta device, no memory), count what
    expected_param_count says; the init zeroes every bn3 gamma."""
    model = CLIP(TINY_RN).init_random_(torch.Generator().manual_seed(0))
    assert count_params(model) == expected_param_count(TINY_RN)
    visual = model.visual.requires_grad_(False)
    assert float(visual.stage1.down.bn3.scale.abs().sum()) == 0.0
    assert float(visual.stage1.down.bn1.scale.min()) == 1.0
    k = visual.stem.conv1.kernel
    assert abs(float(k.std()) - (3 * 3 * 3) ** -0.5) < 0.1
    names = [n for n in CLIP_MODEL_SPECS if n.startswith("RN")]
    assert names == ["RN50", "RN101", "RN50x4", "RN50x16", "RN50x64"]
    for name in names:
        spec = CLIP_MODEL_SPECS[name]
        with torch.device("meta"):
            m = CLIP(spec)
        assert count_params(m) == expected_param_count(spec) == ref_expected_param_count(
            _ref_spec(spec))


def test_npz_round_trip(tiny, tmp_path):
    """The port writes and reads a ResNet npz; the JAX package reads the
    port's file and the port reads the JAX package's, leaf for leaf."""
    params, model = tiny
    path = save_params(tmp_path / "rn", params, TINY_RN)
    tree, spec = load_params(path)
    assert isinstance(spec, CLIPResNetSpec) and spec == TINY_RN
    ref_tree, ref_spec = ref_load_params(path)
    assert dataclasses.asdict(ref_spec) == dataclasses.asdict(TINY_RN)
    ref_path = ref_save_params(tmp_path / "ref_rn", params, _ref_spec(TINY_RN))
    for a, b, c in zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(tree),
                       jax.tree_util.tree_leaves(ref_tree)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, np.asarray(c))
    loaded, _ = load_model(ref_path, device="cpu")
    images = torch.from_numpy(_images(TINY_RN, n=2))
    np.testing.assert_array_equal(encode_image(loaded, images).numpy(),
                                  encode_image(model, images).numpy())


def test_engine_indexes_and_searches_with_a_resnet_checkpoint(tmp_path, monkeypatch):
    """An engine on a ResNet checkpoint (the release vocabulary, so the
    tokenizer's ids fit) indexes a folder at the spec's image size and
    answers text and image searches; an indexed image finds itself."""
    spec = dataclasses.replace(TINY_RN, vocab_size=49408, context_length=77)
    ckpt = save_params(tmp_path / "rn.npz", _params(spec, seed=2), spec)
    for key in list(os.environ):
        if key.startswith("EVOSSEARCH_"):
            monkeypatch.delenv(key)
    monkeypatch.setenv("EVOSSEARCH_CHECKPOINT", str(ckpt))
    monkeypatch.setenv("EVOSSEARCH_COMPUTE_DTYPE", "float32")
    monkeypatch.setenv("EVOSSEARCH_BATCH_SIZE", "4")
    monkeypatch.setenv("EVOSSEARCH_FAST_DECODE", "0")
    folder = tmp_path / "photos"
    folder.mkdir()
    rng = np.random.default_rng(0)
    for i in range(5):
        arr = rng.integers(0, 256, (96, 128, 3), dtype=np.uint8)
        Image.fromarray(arr).save(folder / f"img_{i}.jpg", quality=90)
    eng = SearchEngine(cfg=Config(env_path=tmp_path / "missing.env"), device="cpu")
    try:
        assert eng.spec == spec and isinstance(eng.params.visual, resnet.ModifiedResNet)
        assert eng.index_folder(str(folder)) == 5
        scores, idx, reader = eng.search_text(str(folder), "a photo", 3)
        assert len(scores) == 3 and (np.diff(scores) <= 1e-6).all()
        assert reader.dim == spec.embed_dim and reader.model == spec.name
        s, i, r = eng.search_image(str(folder), Image.open(folder / "img_2.jpg"), 3)
        assert r.paths[int(i[0])].endswith("img_2.jpg") and s[0] > 0.95
    finally:
        eng.close()


def test_engine_on_the_rn50_spec_without_a_checkpoint(tmp_path, monkeypatch):
    """EVOSSEARCH_CLIP_MODEL=RN50 with no checkpoint: the seeded random
    init at RN50's full width, encoding at its 224 px and 1024 wide."""
    for key in list(os.environ):
        if key.startswith("EVOSSEARCH_"):
            monkeypatch.delenv(key)
    monkeypatch.setenv("EVOSSEARCH_CLIP_MODEL", "RN50")
    monkeypatch.setenv("EVOSSEARCH_COMPUTE_DTYPE", "float32")
    eng = SearchEngine(cfg=Config(env_path=tmp_path / "missing.env"), device="cpu")
    try:
        assert eng.spec is CLIP_MODEL_SPECS["RN50"] and eng.spec.image_size == 224
        emb = eng.encode_images([np.zeros((300, 400, 3), np.uint8)])
        assert emb.shape == (1, 1024) and np.isfinite(emb).all()
        np.testing.assert_allclose(np.linalg.norm(emb, axis=1), 1.0, atol=1e-5)
        assert count_params(eng.params) == expected_param_count(eng.spec)
    finally:
        eng.close()
