"""Save/load of param pytrees (.npz) and the bridge onto the port's modules.

The reference's only weights artifact is the downloaded OpenAI .pt
(oldapp.py:28); here fine-tuned or converted weights persist in a simple
flat-key npz with a JSON-encoded spec, so a server can boot from either an
OpenAI/HF checkpoint (models/convert.py) or a native one.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from ..core.constants import CLIPModelSpec, CLIPResNetSpec
from ..core.device import resolve_device


def _flatten(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    flat = {}
    for key, value in tree.items():
        name = f"{prefix}/{key}" if prefix else key
        if isinstance(value, dict):
            flat.update(_flatten(value, name))
        else:
            flat[name] = np.asarray(value)
    return flat


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for name, value in flat.items():
        parts = name.split("/")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return tree


def save_params(path: str | Path, params: dict, spec: CLIPModelSpec) -> Path:
    """Write a native checkpoint; returns the ACTUAL path written.

    np.savez silently appends ``.npz`` to suffix-less paths, which would
    desynchronize the saved file from what callers report/load — so the
    path is normalized here and returned."""
    path = Path(path)
    if path.suffix != ".npz":
        path = path.with_name(path.name + ".npz")
    path.parent.mkdir(parents=True, exist_ok=True)
    flat = _flatten(params)
    spec_dict = dict(dataclasses.asdict(spec), family=spec.family)
    flat["__spec__"] = np.frombuffer(
        json.dumps(spec_dict).encode(), dtype=np.uint8
    )
    np.savez(path, **flat)
    return path


def load_params(path: str | Path) -> tuple[dict, CLIPModelSpec]:
    with np.load(Path(path), allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files}
    spec_raw = bytes(flat.pop("__spec__")).decode()
    spec_dict = json.loads(spec_raw)
    # pre-round-4 checkpoints carry no family key: they are all ViT
    family = spec_dict.pop("family", "vit")
    cls = CLIPResNetSpec if family == "resnet" else CLIPModelSpec
    spec = cls(**spec_dict)
    return _unflatten(flat), spec


# tree keys whose leaves stack one module per layer on a leading axis
_STACKED = ("blocks", "rest")


def named_from_tree(tree: dict) -> dict[str, np.ndarray]:
    """The JAX package's pytree (numpy leaves) as the port's module names:
    layer ``l`` of a stacked leaf ``visual/blocks/attn/wqkv`` becomes
    ``visual.blocks.l.attn.wqkv``, block ``l`` of a ResNet stage's
    stacked tail ``visual/stage3/rest/conv1/kernel`` becomes
    ``visual.stage3.rest.l.conv1.kernel``."""
    named = {}
    for name, value in _flatten(tree).items():
        arr = np.asarray(value)
        parts = name.split("/")
        stacked = [p for p in _STACKED if p in parts]
        if stacked:
            at = parts.index(stacked[0]) + 1
            for layer in range(arr.shape[0]):
                named[".".join(parts[:at] + [str(layer)] + parts[at:])] = arr[layer]
        else:
            named[".".join(parts)] = arr
    return named


def tree_key(name: str) -> tuple[str, int | None]:
    """A module name's pytree key and layer: ``visual.blocks.3.attn.wqkv``
    -> (``visual/blocks/attn/wqkv``, 3); an unstacked name has layer
    None."""
    parts = name.split(".")
    at = next((i + 1 for i, p in enumerate(parts[:-1])
               if p in _STACKED and parts[i + 1].isdigit()), None)
    if at is None:
        return "/".join(parts), None
    return "/".join(parts[:at] + parts[at + 1:]), int(parts[at])


def tree_from_named(named: dict) -> dict:
    """The inverse of ``named_from_tree``: per-layer entries restacked
    into ``(L, ...)`` leaves, numpy throughout."""
    flat: dict = {}
    for name, value in named.items():
        key, layer = tree_key(name)
        if layer is None:
            flat[key] = np.asarray(value)
        else:
            flat.setdefault(key, {})[layer] = np.asarray(value)
    for key, value in flat.items():
        if isinstance(value, dict):
            flat[key] = np.stack([value[layer] for layer in range(len(value))])
    return _unflatten(flat)


def tree_leaves(tree: dict) -> list:
    """Leaves in ``jax.tree_util.tree_leaves`` order (sorted keys)."""
    out = []
    for key in sorted(tree):
        value = tree[key]
        out.extend(tree_leaves(value) if isinstance(value, dict) else [value])
    return out


def params_to_numpy(model) -> dict:
    """A port :class:`CLIP` module's parameters as the JAX package's param
    pytree: float32 numpy leaves, blocks restacked into ``(L, ...)``; the
    inverse of ``params_from_numpy`` (``save_params`` writes it)."""
    return tree_from_named({
        name: p.detach().float().cpu().numpy() for name, p in model.state_dict().items()
    })


def params_from_numpy(tree: dict, spec: CLIPModelSpec,
                      device: str | torch.device | None = None):
    """The JAX package's param pytree (numpy leaves: stacked ``(L, ...)``
    block leaves, ``(in, out)`` dense kernels, HWIO conv kernels) as a
    port :class:`CLIP` module on ``device`` (None: the GPU, or a raise
    without one; pass ``"cpu"`` for the CPU), named as
    ``named_from_tree`` says; every leaf must match a parameter
    exactly."""
    from .clip import CLIP

    device = resolve_device(device)
    state = {
        name: torch.from_numpy(np.array(arr, np.float32))  # writable copies
        for name, arr in named_from_tree(tree).items()
    }
    with torch.device("meta"):
        model = CLIP(spec)
    model.load_state_dict(state, strict=True, assign=True)
    return model.to(device).eval()


def load_model(path: str | Path, device: str | torch.device | None = None):
    """Native npz checkpoint -> (CLIP module on ``device``, spec); the
    device as ``params_from_numpy`` resolves it."""
    tree, spec = load_params(path)
    return params_from_numpy(tree, spec, device), spec
