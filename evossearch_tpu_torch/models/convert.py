"""Checkpoint converters: OpenAI CLIP `.pt` / HuggingFace CLIPModel state
dicts -> the param tree with numpy leaves that the JAX package's converter
returns, leaf for leaf (``evossearch_tpu.models.convert``).

The reference app obtains weights via `clip.load(...)` (oldapp.py:28),
which downloads the OpenAI TorchScript archive. Here the weights arrive as
a torch state_dict and are re-laid-out into that tree, which
``models.checkpoint.params_from_numpy`` turns into the port's modules (one
layout mapping, shared with the npz checkpoints):

  * torch Linear stores (out, in); we store (in, out) for ``x @ W``.
  * OpenAI fuses qkv as ``attn.in_proj_weight`` (3W, W); we split q/k/v.
  * conv1 patch kernels (out, in, kh, kw) become a (kh*kw*in, out) matmul
    kernel, matching the (ph, pw, c) patch flatten order in clip._patchify.
  * per-layer tensors are STACKED on a leading axis (the JAX package's
    scan layout; ``params_from_numpy`` unstacks them into block modules).
"""

from __future__ import annotations

import numpy as np

from ..core.constants import CLIP_MODEL_SPECS, CLIPModelSpec, CLIPResNetSpec


def _np(t) -> np.ndarray:
    """torch tensor | np array -> float32/int numpy array."""
    if hasattr(t, "detach"):
        t = t.detach().cpu().float().numpy()
    return np.asarray(t)


def _conv_to_matmul_kernel(w) -> np.ndarray:
    """(out, in, kh, kw) conv kernel -> (kh*kw*in, out) matmul kernel."""
    w = _np(w)
    out_ch = w.shape[0]
    return w.transpose(2, 3, 1, 0).reshape(-1, out_ch)


def _stack(tensors: list[np.ndarray]) -> np.ndarray:
    return np.stack(tensors, axis=0)


def _ln(sd: dict, prefix: str) -> dict:
    return {"scale": _np(sd[f"{prefix}.weight"]), "bias": _np(sd[f"{prefix}.bias"])}


# ---------------------------------------------------------------- HF naming


def _hf_tower(sd: dict, prefix: str, layers: int) -> dict:
    """Stack one HF CLIPEncoder (`{prefix}.encoder.layers.N.*`)."""
    def per_layer(field_fn):
        return _stack([field_fn(i) for i in range(layers)])

    def lin_w(i, name):
        return _np(sd[f"{prefix}.encoder.layers.{i}.{name}.weight"]).T

    def lin_b(i, name):
        return _np(sd[f"{prefix}.encoder.layers.{i}.{name}.bias"])

    def ln(i, name, field):
        return _np(sd[f"{prefix}.encoder.layers.{i}.{name}.{field}"])

    return {
        "ln_1": {
            "scale": per_layer(lambda i: ln(i, "layer_norm1", "weight")),
            "bias": per_layer(lambda i: ln(i, "layer_norm1", "bias")),
        },
        "attn": {
            # fused qkv layout: (in, 3W) = concat of q/k/v output dims
            "wqkv": per_layer(
                lambda i: np.concatenate(
                    [lin_w(i, f"self_attn.{p}_proj") for p in "qkv"], axis=-1
                )
            ),
            "bqkv": per_layer(
                lambda i: np.concatenate(
                    [lin_b(i, f"self_attn.{p}_proj") for p in "qkv"]
                )
            ),
            "wo": per_layer(lambda i: lin_w(i, "self_attn.out_proj")),
            "bo": per_layer(lambda i: lin_b(i, "self_attn.out_proj")),
        },
        "ln_2": {
            "scale": per_layer(lambda i: ln(i, "layer_norm2", "weight")),
            "bias": per_layer(lambda i: ln(i, "layer_norm2", "bias")),
        },
        "mlp": {
            "w1": per_layer(lambda i: lin_w(i, "mlp.fc1")),
            "b1": per_layer(lambda i: lin_b(i, "mlp.fc1")),
            "w2": per_layer(lambda i: lin_w(i, "mlp.fc2")),
            "b2": per_layer(lambda i: lin_b(i, "mlp.fc2")),
        },
    }


def from_hf_state_dict(sd: dict, vision_layers: int, text_layers: int) -> dict:
    """HuggingFace `CLIPModel.state_dict()` -> evossearch param pytree."""
    emb = "vision_model.embeddings"
    return {
        "visual": {
            "patch_embed": {
                "kernel": _conv_to_matmul_kernel(sd[f"{emb}.patch_embedding.weight"])
            },
            "class_embedding": _np(sd[f"{emb}.class_embedding"]),
            "pos_embed": _np(sd[f"{emb}.position_embedding.weight"]),
            # sic: HF ships the typo'd key "pre_layrnorm"
            "ln_pre": _ln(sd, "vision_model.pre_layrnorm"),
            "blocks": _hf_tower(sd, "vision_model", vision_layers),
            "ln_post": _ln(sd, "vision_model.post_layernorm"),
            "proj": _np(sd["visual_projection.weight"]).T,
        },
        "text": {
            "token_embed": _np(sd["text_model.embeddings.token_embedding.weight"]),
            "pos_embed": _np(sd["text_model.embeddings.position_embedding.weight"]),
            "blocks": _hf_tower(sd, "text_model", text_layers),
            "ln_final": _ln(sd, "text_model.final_layer_norm"),
            "proj": _np(sd["text_projection.weight"]).T,
        },
        "logit_scale": _np(sd["logit_scale"]).reshape(()),
    }


# ------------------------------------------------------------ OpenAI naming


def _openai_tower(sd: dict, prefix: str, layers: int) -> dict:
    """Stack one OpenAI transformer (`{prefix}.resblocks.N.*`)."""
    def per_layer(field_fn):
        return _stack([field_fn(i) for i in range(layers)])

    def lin_w(i, name):
        return _np(sd[f"{prefix}.resblocks.{i}.{name}.weight"]).T

    def lin_b(i, name):
        return _np(sd[f"{prefix}.resblocks.{i}.{name}.bias"])

    def ln(i, name, field):
        return _np(sd[f"{prefix}.resblocks.{i}.{name}.{field}"])

    return {
        "ln_1": {
            "scale": per_layer(lambda i: ln(i, "ln_1", "weight")),
            "bias": per_layer(lambda i: ln(i, "ln_1", "bias")),
        },
        "attn": {
            # OpenAI stores qkv already fused as in_proj (3W, W); transpose
            # gives our (in, 3W) layout directly
            "wqkv": per_layer(
                lambda i: _np(sd[f"{prefix}.resblocks.{i}.attn.in_proj_weight"]).T
            ),
            "bqkv": per_layer(
                lambda i: _np(sd[f"{prefix}.resblocks.{i}.attn.in_proj_bias"])
            ),
            "wo": per_layer(lambda i: lin_w(i, "attn.out_proj")),
            "bo": per_layer(lambda i: lin_b(i, "attn.out_proj")),
        },
        "ln_2": {
            "scale": per_layer(lambda i: ln(i, "ln_2", "weight")),
            "bias": per_layer(lambda i: ln(i, "ln_2", "bias")),
        },
        "mlp": {
            "w1": per_layer(lambda i: lin_w(i, "mlp.c_fc")),
            "b1": per_layer(lambda i: lin_b(i, "mlp.c_fc")),
            "w2": per_layer(lambda i: lin_w(i, "mlp.c_proj")),
            "b2": per_layer(lambda i: lin_b(i, "mlp.c_proj")),
        },
    }


# ------------------------------------------------- OpenAI ResNet variants


def _bn_params(sd: dict, prefix: str) -> dict:
    return {
        "scale": _np(sd[f"{prefix}.weight"]),
        "bias": _np(sd[f"{prefix}.bias"]),
        "mean": _np(sd[f"{prefix}.running_mean"]),
        "var": _np(sd[f"{prefix}.running_var"]),
    }


def _conv_params(sd: dict, key: str) -> dict:
    """torch (out, in, kh, kw) -> our NHWC kernel (kh, kw, in, out)."""
    return {"kernel": _np(sd[key]).transpose(2, 3, 1, 0)}


def _stack_trees(trees: list[dict]) -> dict:
    """Stack same-structured trees leaf by leaf on a new leading axis."""
    return {
        key: _stack_trees([t[key] for t in trees])
        if isinstance(value, dict) else _stack([t[key] for t in trees])
        for key, value in trees[0].items()
    }


def _resnet_block(sd: dict, prefix: str) -> dict:
    p = {
        "conv1": _conv_params(sd, f"{prefix}.conv1.weight"),
        "bn1": _bn_params(sd, f"{prefix}.bn1"),
        "conv2": _conv_params(sd, f"{prefix}.conv2.weight"),
        "bn2": _bn_params(sd, f"{prefix}.bn2"),
        "conv3": _conv_params(sd, f"{prefix}.conv3.weight"),
        "bn3": _bn_params(sd, f"{prefix}.bn3"),
    }
    # OpenAI names the shortcut Sequential's children "-1"/"0"/"1"
    # (AvgPool2d/Conv2d/BatchNorm2d) — only 0/1 carry tensors.
    if f"{prefix}.downsample.0.weight" in sd:
        p["downsample"] = {
            "conv": _conv_params(sd, f"{prefix}.downsample.0.weight"),
            "bn": _bn_params(sd, f"{prefix}.downsample.1"),
        }
    return p


def infer_openai_resnet_spec(sd: dict) -> CLIPResNetSpec:
    """Infer the RN* variant from OpenAI state_dict tensor shapes (mirrors
    clip/model.py's build_model counting `visual.layerN` block indices)."""
    counts = tuple(
        len({k.split(".")[2] for k in sd if k.startswith(f"visual.layer{i}.")})
        for i in (1, 2, 3, 4)
    )
    vision_width = _np(sd["visual.conv3.weight"]).shape[0]  # stem out
    embed_dim = _np(sd["visual.attnpool.c_proj.weight"]).shape[0]
    n_tokens = _np(sd["visual.attnpool.positional_embedding"]).shape[0]
    image_size = int(round((n_tokens - 1) ** 0.5)) * 32
    text_width = _np(sd["ln_final.weight"]).shape[0]
    text_layers = len(
        {k.split(".")[2] for k in sd if k.startswith("transformer.resblocks.")}
    )
    for spec in CLIP_MODEL_SPECS.values():
        if (
            spec.family == "resnet"
            and spec.vision_layers == counts
            and spec.vision_width == vision_width
            and spec.embed_dim == embed_dim
            and spec.image_size == image_size
        ):
            return spec
    return CLIPResNetSpec(
        name=f"custom-rn{sum(counts)}", image_size=image_size,
        vision_width=vision_width, vision_layers=counts,
        vision_heads=vision_width * 32 // 64,
        text_width=text_width, text_layers=text_layers,
        # OpenAI build_model: transformer_width // 64 (>= 8 for every
        # release); clamp so sub-64-wide custom checkpoints stay valid
        text_heads=max(text_width // 64, 1),
        vocab_size=_np(sd["token_embedding.weight"]).shape[0],
        context_length=_np(sd["positional_embedding"]).shape[0],
        embed_dim=embed_dim,
    )


def _openai_resnet_visual(sd: dict, spec: CLIPResNetSpec) -> dict:
    visual = {
        "stem": {
            "conv1": _conv_params(sd, "visual.conv1.weight"),
            "bn1": _bn_params(sd, "visual.bn1"),
            "conv2": _conv_params(sd, "visual.conv2.weight"),
            "bn2": _bn_params(sd, "visual.bn2"),
            "conv3": _conv_params(sd, "visual.conv3.weight"),
            "bn3": _bn_params(sd, "visual.bn3"),
        },
    }
    for i, n_blocks in enumerate(spec.vision_layers):
        stage = {"down": _resnet_block(sd, f"visual.layer{i + 1}.0")}
        if n_blocks > 1:
            rest = [
                _resnet_block(sd, f"visual.layer{i + 1}.{j}")
                for j in range(1, n_blocks)
            ]
            stage["rest"] = _stack_trees(rest)
        visual[f"stage{i + 1}"] = stage
    ap = "visual.attnpool"
    visual["attnpool"] = {
        "pos_embed": _np(sd[f"{ap}.positional_embedding"]),
        "wq": _np(sd[f"{ap}.q_proj.weight"]).T,
        "bq": _np(sd[f"{ap}.q_proj.bias"]),
        "wk": _np(sd[f"{ap}.k_proj.weight"]).T,
        "bk": _np(sd[f"{ap}.k_proj.bias"]),
        "wv": _np(sd[f"{ap}.v_proj.weight"]).T,
        "bv": _np(sd[f"{ap}.v_proj.bias"]),
        "wc": _np(sd[f"{ap}.c_proj.weight"]).T,
        "bc": _np(sd[f"{ap}.c_proj.bias"]),
    }
    return visual


def infer_openai_spec(sd: dict) -> CLIPModelSpec:
    """Infer the CLIP ViT variant from OpenAI state_dict tensor shapes."""
    vision_width = _np(sd["visual.conv1.weight"]).shape[0]
    patch_size = _np(sd["visual.conv1.weight"]).shape[-1]
    vision_layers = len(
        {k.split(".")[3] for k in sd if k.startswith("visual.transformer.resblocks.")}
    )
    embed_dim = _np(sd["text_projection"]).shape[1]
    grid = int(round((_np(sd["visual.positional_embedding"]).shape[0] - 1) ** 0.5))
    image_size = grid * patch_size
    text_width = _np(sd["ln_final.weight"]).shape[0]
    text_layers = len(
        {k.split(".")[2] for k in sd
         if k.startswith("transformer.resblocks.")}
    )
    for spec in CLIP_MODEL_SPECS.values():
        if (
            spec.family == "vit"
            and spec.vision_width == vision_width
            and spec.patch_size == patch_size
            and spec.vision_layers == vision_layers
            and spec.embed_dim == embed_dim
            # image_size MUST participate: OpenAI's ViT-L/14@336px matches
            # ViT-L/14 on every other field but carries a 577-row
            # pos_embed that cannot serve 224px preprocessing.
            and spec.image_size == image_size
        ):
            return spec
    return CLIPModelSpec(
        name=f"custom-p{patch_size}", image_size=image_size, patch_size=patch_size,
        vision_width=vision_width, vision_layers=vision_layers,
        vision_heads=vision_width // 64,
        text_width=text_width, text_layers=text_layers, text_heads=text_width // 64,
        vocab_size=_np(sd["token_embedding.weight"]).shape[0],
        context_length=_np(sd["positional_embedding"]).shape[0],
        embed_dim=embed_dim,
    )


def _openai_text(sd: dict, text_layers: int) -> dict:
    return {
        "token_embed": _np(sd["token_embedding.weight"]),
        "pos_embed": _np(sd["positional_embedding"]),
        "blocks": _openai_tower(sd, "transformer", text_layers),
        "ln_final": _ln(sd, "ln_final"),
        "proj": _np(sd["text_projection"]),  # stored (width, embed) already
    }


def from_openai_state_dict(sd: dict) -> tuple[dict, CLIPModelSpec]:
    """OpenAI CLIP release state_dict -> (param pytree, inferred spec).

    Detects the image-tower family the way clip/model.py's build_model
    does: ViT checkpoints carry `visual.proj`, ResNet ones carry
    `visual.attnpool.*`.
    """
    if "visual.attnpool.positional_embedding" in sd:
        spec = infer_openai_resnet_spec(sd)
        params = {
            "visual": _openai_resnet_visual(sd, spec),
            "text": _openai_text(sd, spec.text_layers),
            "logit_scale": _np(sd["logit_scale"]).reshape(()),
        }
        return params, spec
    spec = infer_openai_spec(sd)
    params = {
        "visual": {
            "patch_embed": {"kernel": _conv_to_matmul_kernel(sd["visual.conv1.weight"])},
            "class_embedding": _np(sd["visual.class_embedding"]),
            "pos_embed": _np(sd["visual.positional_embedding"]),
            "ln_pre": _ln(sd, "visual.ln_pre"),
            "blocks": _openai_tower(sd, "visual.transformer", spec.vision_layers),
            "ln_post": _ln(sd, "visual.ln_post"),
            "proj": _np(sd["visual.proj"]),  # stored (width, embed) already
        },
        "text": _openai_text(sd, spec.text_layers),
        "logit_scale": _np(sd["logit_scale"]).reshape(()),
    }
    return params, spec


def load_checkpoint(path: str):
    """Load a CLIP checkpoint from disk -> (params, spec).

    Accepts an OpenAI `.pt` (TorchScript archive or plain state_dict pickle)
    or a HuggingFace model directory.
    """
    import os

    if os.path.isdir(path):
        import json

        import torch

        with open(os.path.join(path, "config.json")) as f:
            cfg = json.load(f)
        vcfg, tcfg = cfg["vision_config"], cfg["text_config"]
        bin_path = os.path.join(path, "pytorch_model.bin")
        st_path = os.path.join(path, "model.safetensors")
        if os.path.exists(st_path):
            from safetensors.torch import load_file

            sd = load_file(st_path)
        else:
            sd = torch.load(bin_path, map_location="cpu", weights_only=True)
        params = from_hf_state_dict(
            sd, vcfg["num_hidden_layers"], tcfg["num_hidden_layers"]
        )
        spec = CLIPModelSpec(
            name=os.path.basename(path),
            image_size=vcfg["image_size"], patch_size=vcfg["patch_size"],
            vision_width=vcfg["hidden_size"],
            vision_layers=vcfg["num_hidden_layers"],
            vision_heads=vcfg["num_attention_heads"],
            text_width=tcfg["hidden_size"], text_layers=tcfg["num_hidden_layers"],
            text_heads=tcfg["num_attention_heads"],
            vocab_size=tcfg["vocab_size"],
            context_length=tcfg["max_position_embeddings"],
            embed_dim=cfg["projection_dim"],
        )
        return params, spec

    import torch

    try:
        model = torch.jit.load(path, map_location="cpu")
        sd = model.state_dict()
    except RuntimeError:
        sd = torch.load(path, map_location="cpu", weights_only=False)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
    return from_openai_state_dict(sd)
