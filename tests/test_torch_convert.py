"""The port's checkpoint converters against the JAX package's: HF and OpenAI
state dicts of a random-init ``transformers.CLIPModel`` (nothing is
downloaded), a synthetic OpenAI ResNet state dict, and ``load_checkpoint``
over an HF directory (safetensors and ``.bin``), a plain pickle ``.pt`` and
a TorchScript archive. The trees are array-equal leaf for leaf and the
inferred specs equal. An engine started on the ``.pt`` matches the JAX
engine on the same file within EMB_ATOL (float32 compute)."""

import dataclasses
import os

import numpy as np
import pytest
import torch
from torch import nn

from evossearch_tpu.core import Config as RefConfig
from evossearch_tpu.engine import SearchEngine as RefEngine
from evossearch_tpu.models import convert as ref_convert
from evossearch_tpu_torch.core import CLIP_MODEL_SPECS, CLIPModelSpec, Config
from evossearch_tpu_torch.engine import SearchEngine
from evossearch_tpu_torch.models import convert

EMB_ATOL = 1e-4
# heads = width // 64, as OpenAI's build_model (and infer_openai_spec) have
# them; the engine's tokenizer needs the release vocab and context
TINY = CLIPModelSpec(
    name="tiny", image_size=64, patch_size=16, vision_width=128,
    vision_layers=2, vision_heads=2, text_width=64, text_layers=2,
    text_heads=1, vocab_size=49408, context_length=77, embed_dim=32,
)


@pytest.fixture(scope="module")
def hf_model():
    from transformers import CLIPConfig, CLIPModel

    cfg = CLIPConfig(
        projection_dim=TINY.embed_dim,
        vision_config=dict(
            image_size=TINY.image_size, patch_size=TINY.patch_size,
            hidden_size=TINY.vision_width, num_hidden_layers=TINY.vision_layers,
            num_attention_heads=TINY.vision_heads,
            intermediate_size=4 * TINY.vision_width, hidden_act="quick_gelu",
        ),
        text_config=dict(
            vocab_size=TINY.vocab_size, hidden_size=TINY.text_width,
            num_hidden_layers=TINY.text_layers, num_attention_heads=TINY.text_heads,
            intermediate_size=4 * TINY.text_width, hidden_act="quick_gelu",
            max_position_embeddings=TINY.context_length,
            eos_token_id=TINY.vocab_size - 1,
        ),
    )
    torch.manual_seed(0)
    return CLIPModel(cfg).eval()


def _openai_sd_from_hf(hf_model) -> dict:
    """Re-key the HF model's tensors into the OpenAI release layout."""
    sd = hf_model.state_dict()
    out = {
        "visual.conv1.weight": sd["vision_model.embeddings.patch_embedding.weight"],
        "visual.class_embedding": sd["vision_model.embeddings.class_embedding"],
        "visual.positional_embedding":
            sd["vision_model.embeddings.position_embedding.weight"],
        "visual.ln_pre.weight": sd["vision_model.pre_layrnorm.weight"],
        "visual.ln_pre.bias": sd["vision_model.pre_layrnorm.bias"],
        "visual.ln_post.weight": sd["vision_model.post_layernorm.weight"],
        "visual.ln_post.bias": sd["vision_model.post_layernorm.bias"],
        "visual.proj": sd["visual_projection.weight"].T.contiguous(),
        "token_embedding.weight": sd["text_model.embeddings.token_embedding.weight"],
        "positional_embedding":
            sd["text_model.embeddings.position_embedding.weight"],
        "ln_final.weight": sd["text_model.final_layer_norm.weight"],
        "ln_final.bias": sd["text_model.final_layer_norm.bias"],
        "text_projection": sd["text_projection.weight"].T.contiguous(),
        "logit_scale": sd["logit_scale"],
    }
    for hf_prefix, oa_prefix, n in [
        ("vision_model", "visual.transformer", TINY.vision_layers),
        ("text_model", "transformer", TINY.text_layers),
    ]:
        for i in range(n):
            h = f"{hf_prefix}.encoder.layers.{i}"
            o = f"{oa_prefix}.resblocks.{i}"
            for a, b in (("ln_1", "layer_norm1"), ("ln_2", "layer_norm2"),
                         ("attn.out_proj", "self_attn.out_proj"),
                         ("mlp.c_fc", "mlp.fc1"), ("mlp.c_proj", "mlp.fc2")):
                out[f"{o}.{a}.weight"] = sd[f"{h}.{b}.weight"]
                out[f"{o}.{a}.bias"] = sd[f"{h}.{b}.bias"]
            for field in ("weight", "bias"):
                out[f"{o}.attn.in_proj_{field}"] = torch.cat(
                    [sd[f"{h}.self_attn.{p}_proj.{field}"] for p in "qkv"]
                )
    return out


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        name = f"{prefix}/{key}" if prefix else key
        if isinstance(value, dict):
            out.update(_flat(value, name))
        else:
            out[name] = np.asarray(value)
    return out


def assert_trees_equal(got: dict, want: dict) -> None:
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def assert_specs_equal(got, want) -> None:
    assert type(got).__name__ == type(want).__name__
    assert got.family == want.family
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_hf_state_dict_converts_equal(hf_model):
    sd = hf_model.state_dict()
    assert_trees_equal(
        convert.from_hf_state_dict(sd, TINY.vision_layers, TINY.text_layers),
        ref_convert.from_hf_state_dict(sd, TINY.vision_layers, TINY.text_layers),
    )


def test_openai_state_dict_converts_equal(hf_model):
    sd = _openai_sd_from_hf(hf_model)
    params, spec = convert.from_openai_state_dict(sd)
    ref_params, ref_spec = ref_convert.from_openai_state_dict(sd)
    assert_trees_equal(params, ref_params)
    assert_specs_equal(spec, ref_spec)
    assert (spec.vision_width, spec.patch_size, spec.text_heads) == (128, 16, 1)
    # the OpenAI layout holds the same tensors as the HF one
    assert_trees_equal(params, convert.from_hf_state_dict(
        hf_model.state_dict(), TINY.vision_layers, TINY.text_layers))


def _vit_shapes(spec) -> dict:
    """An OpenAI ViT state dict's shapes for ``spec``, as zero-strided
    arrays (shape inference reads shapes, never values)."""
    vw, tw, e = spec.vision_width, spec.text_width, spec.embed_dim
    grid = spec.image_size // spec.patch_size
    shapes = {
        "visual.conv1.weight": (vw, 3, spec.patch_size, spec.patch_size),
        "visual.positional_embedding": (grid * grid + 1, vw),
        "text_projection": (tw, e),
        "ln_final.weight": (tw,),
        "token_embedding.weight": (spec.vocab_size, tw),
        "positional_embedding": (spec.context_length, tw),
    }
    for i in range(spec.vision_layers):
        shapes[f"visual.transformer.resblocks.{i}.attn.in_proj_weight"] = (3 * vw, vw)
    for i in range(spec.text_layers):
        shapes[f"transformer.resblocks.{i}.attn.in_proj_weight"] = (3 * tw, tw)
    return {k: np.broadcast_to(np.float32(0), s) for k, s in shapes.items()}


@pytest.mark.parametrize(
    "name", [n for n, s in CLIP_MODEL_SPECS.items() if s.family == "vit"] + ["custom"]
)
def test_infer_openai_spec_agrees(name):
    spec = TINY if name == "custom" else CLIP_MODEL_SPECS[name]
    sd = _vit_shapes(spec)
    got, want = convert.infer_openai_spec(sd), ref_convert.infer_openai_spec(sd)
    assert_specs_equal(got, want)
    if name != "custom":
        assert got == spec


# ------------------------------------------------------------ ResNet layout

RN_WIDTH, RN_LAYERS, RN_IMAGE, RN_EMBED = 8, (1, 2, 1, 2), 64, 24


def _resnet_sd() -> dict:
    """A seeded OpenAI ModifiedResNet state dict (clip/model.py's key
    layout: a three-conv stem, Bottleneck stages whose first block has
    the downsample shortcut, an attention pool) plus a text tower."""
    rng = np.random.default_rng(3)
    sd = {}

    def t(key, *shape):
        sd[key] = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    def bn(prefix, c):
        for field in ("weight", "bias", "running_mean"):
            t(f"{prefix}.{field}", c)
        sd[f"{prefix}.running_var"] = torch.from_numpy(
            rng.uniform(0.5, 2.0, c).astype(np.float32))
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)

    w = RN_WIDTH
    t("visual.conv1.weight", w // 2, 3, 3, 3)
    bn("visual.bn1", w // 2)
    t("visual.conv2.weight", w // 2, w // 2, 3, 3)
    bn("visual.bn2", w // 2)
    t("visual.conv3.weight", w, w // 2, 3, 3)
    bn("visual.bn3", w)
    inplanes = w
    for stage, blocks in enumerate(RN_LAYERS):
        planes = w * 2 ** stage
        for j in range(blocks):
            p = f"visual.layer{stage + 1}.{j}"
            t(f"{p}.conv1.weight", planes, inplanes, 1, 1)
            bn(f"{p}.bn1", planes)
            t(f"{p}.conv2.weight", planes, planes, 3, 3)
            bn(f"{p}.bn2", planes)
            t(f"{p}.conv3.weight", planes * 4, planes, 1, 1)
            bn(f"{p}.bn3", planes * 4)
            if j == 0:
                t(f"{p}.downsample.0.weight", planes * 4, inplanes, 1, 1)
                bn(f"{p}.downsample.1", planes * 4)
            inplanes = planes * 4
    c = w * 32
    t("visual.attnpool.positional_embedding", (RN_IMAGE // 32) ** 2 + 1, c)
    for proj in ("q_proj", "k_proj", "v_proj"):
        t(f"visual.attnpool.{proj}.weight", c, c)
        t(f"visual.attnpool.{proj}.bias", c)
    t("visual.attnpool.c_proj.weight", RN_EMBED, c)
    t("visual.attnpool.c_proj.bias", RN_EMBED)
    tw, ctx, vocab = 64, 16, 100
    t("token_embedding.weight", vocab, tw)
    t("positional_embedding", ctx, tw)
    t("ln_final.weight", tw)
    t("ln_final.bias", tw)
    t("text_projection", tw, RN_EMBED)
    sd["logit_scale"] = torch.tensor(4.6052)
    for i in range(2):
        p = f"transformer.resblocks.{i}"
        for ln in ("ln_1", "ln_2"):
            t(f"{p}.{ln}.weight", tw)
            t(f"{p}.{ln}.bias", tw)
        t(f"{p}.attn.in_proj_weight", 3 * tw, tw)
        t(f"{p}.attn.in_proj_bias", 3 * tw)
        t(f"{p}.attn.out_proj.weight", tw, tw)
        t(f"{p}.attn.out_proj.bias", tw)
        t(f"{p}.mlp.c_fc.weight", 4 * tw, tw)
        t(f"{p}.mlp.c_fc.bias", 4 * tw)
        t(f"{p}.mlp.c_proj.weight", tw, 4 * tw)
        t(f"{p}.mlp.c_proj.bias", tw)
    return sd


def test_resnet_state_dict_converts_equal():
    sd = _resnet_sd()
    params, spec = convert.from_openai_state_dict(sd)
    ref_params, ref_spec = ref_convert.from_openai_state_dict(sd)
    assert_trees_equal(params, ref_params)
    assert_specs_equal(spec, ref_spec)
    assert spec.family == "resnet" and spec.vision_layers == RN_LAYERS
    # stages with more than one block stack the rest on a leading axis
    assert params["visual"]["stage4"]["rest"]["conv1"]["kernel"].shape[0] == 1
    assert "rest" not in params["visual"]["stage1"]
    assert_specs_equal(convert.infer_openai_resnet_spec(sd),
                       ref_convert.infer_openai_resnet_spec(sd))


def test_resnet_checkpoint_raises_before_any_index(tmp_path):
    """The engine converts a ResNet checkpoint while it starts, before an
    index exists. Until the ResNet tower was ported (A14) it raised there;
    now it starts on the checkpoint's spec and encodes at its width."""
    path = tmp_path / "rn.pt"
    torch.save(_resnet_sd(), path)
    cfg = Config(env_path=tmp_path / "missing.env")
    cfg.CHECKPOINT_PATH = str(path)
    engine = SearchEngine(cfg=cfg, device="cpu")
    assert engine.spec.family == "resnet" and engine.spec.vision_layers == RN_LAYERS
    emb = engine.encode_images([np.zeros((80, 96, 3), np.uint8)])
    assert emb.shape == (1, RN_EMBED) and np.isfinite(emb).all()
    engine.close()


# -------------------------------------------------------- load_checkpoint


class _Root(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


def _torchscript_archive(sd: dict, path) -> None:
    """A TorchScript archive whose state dict has exactly ``sd``'s keys,
    like the OpenAI release files (modules nested by the dotted names)."""
    root = _Root()
    for key, value in sd.items():
        *parents, leaf = key.split(".")
        mod = root
        for part in parents:
            if part not in mod._modules:
                mod.add_module(part, nn.Module())
            mod = mod._modules[part]
        mod.register_parameter(leaf, nn.Parameter(value.clone(), requires_grad=False))
    torch.jit.save(torch.jit.script(root), str(path))


@pytest.fixture(scope="module")
def checkpoints(hf_model, tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpts")
    sd = _openai_sd_from_hf(hf_model)
    paths = {"pickle": root / "plain.pt", "torchscript": root / "jit.pt"}
    torch.save(sd, paths["pickle"])
    _torchscript_archive(sd, paths["torchscript"])
    for name, safe in (("safetensors", True), ("bin", False)):
        paths[name] = root / f"hf_{name}"
        hf_model.save_pretrained(str(paths[name]), safe_serialization=safe)
    return paths


@pytest.mark.parametrize("kind", ["safetensors", "bin", "pickle", "torchscript"])
def test_load_checkpoint_equal(checkpoints, kind):
    path = checkpoints[kind]
    params, spec = convert.load_checkpoint(str(path))
    ref_params, ref_spec = ref_convert.load_checkpoint(str(path))
    assert_trees_equal(params, ref_params)
    assert_specs_equal(spec, ref_spec)
    if kind in ("safetensors", "bin"):
        file = "model.safetensors" if kind == "safetensors" else "pytorch_model.bin"
        assert (path / file).exists()
        assert spec.vision_heads == TINY.vision_heads


def test_torchscript_and_pickle_load_the_same_tree(checkpoints):
    a, spec_a = convert.load_checkpoint(str(checkpoints["torchscript"]))
    b, spec_b = convert.load_checkpoint(str(checkpoints["pickle"]))
    assert_trees_equal(a, b)
    assert spec_a == spec_b


def _engines(tmp_path, ckpt):
    saved = dict(os.environ)
    try:
        for key in list(os.environ):
            if key.startswith("EVOSSEARCH_"):
                del os.environ[key]
        os.environ.update({"EVOSSEARCH_COMPUTE_DTYPE": "float32",
                           "EVOSSEARCH_CHECKPOINT": str(ckpt)})
        env = tmp_path / "missing.env"
        cfg, ref_cfg = Config(env_path=env), RefConfig(env_path=env)
    finally:
        os.environ.clear()
        os.environ.update(saved)
    return SearchEngine(cfg=cfg, device="cpu"), RefEngine(cfg=ref_cfg)


@pytest.mark.parametrize("kind", ["torchscript", "safetensors"])
def test_engine_on_converted_checkpoint_matches_jax(checkpoints, tmp_path, kind):
    port, ref = _engines(tmp_path, checkpoints[kind])
    try:
        assert_specs_equal(port.spec, ref.spec)
        assert port.spec.vision_width == TINY.vision_width
        rng = np.random.default_rng(4)
        images = [rng.integers(0, 256, hw + (3,), dtype=np.uint8)
                  for hw in ((64, 64), (90, 120), (200, 150))]
        np.testing.assert_allclose(port.encode_images(images),
                                   ref.encode_images(images), atol=EMB_ATOL)
        for text in ("a photo of a dog", "red car"):
            np.testing.assert_allclose(port.encode_text(text), ref.encode_text(text),
                                       atol=EMB_ATOL)
    finally:
        port.close()
