"""Save/load of param pytrees (.npz) and the bridge onto the port's modules.

The reference's only weights artifact is the downloaded OpenAI .pt
(oldapp.py:28); here fine-tuned or converted weights persist in a simple
flat-key npz with a JSON-encoded spec, so a server can boot from either an
OpenAI/HF checkpoint (models/convert.py) or a native one.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
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


# -- sharded checkpoints: the port's own format --
#
# The npz format above gathers everything to one host. A mesh run's state
# (params, optionally the Adam state) is written shard by shard instead,
# each distinct slice from the device that holds it, and restored straight
# onto the target's devices, on the same mesh shape or another. The JAX
# package writes its sharded state with orbax (an OCDBT tree only
# tensorstore reads); neither package reads the other's sharded directory:
# they exchange training state through clip.npz and train_state.npz.
#
#   <dir>/manifest.json   format, version, mesh shape, and per leaf: its
#                         tree key, global shape, dtype, spec, and each
#                         distinct shard's file and slice ([start, stop)
#                         per dim); a scalar leaf (the Adam count) holds
#                         its value
#   <dir>/<leaf>.<j>.npy  one per distinct shard (bfloat16 as its uint16
#                         bits), written once however many positions hold
#                         it
#
# The manifest is written last, so an interrupted save leaves no readable
# checkpoint.

SHARDED_FORMAT = "evossearch_tpu_torch.sharded"
SHARDED_VERSION = 1
_MANIFEST = "manifest.json"
# what an orbax checkpoint directory holds (the JAX package's save_sharded)
_ORBAX_MARKERS = ("_METADATA", "_CHECKPOINT_METADATA", "manifest.ocdbt")


def tree_items(node, prefix: str = "") -> dict:
    """A pytree's leaves by ``/``-joined key, the leaves as they are; an
    object with ``tree()`` (``ShardedCLIP``, ``ShardedAdamState``) stands
    for its tree."""
    if hasattr(node, "tree"):
        node = node.tree()
    if not isinstance(node, dict):
        return {prefix: node}
    out = {}
    for key, value in node.items():
        out.update(tree_items(value, f"{prefix}/{key}" if prefix else key))
    return out


def _restore_like(node, restored: dict, prefix: str = ""):
    """``node``'s structure with its leaves from ``restored`` (by key); an
    object with ``tree()`` comes back through its ``from_tree``."""
    if hasattr(node, "tree"):
        return node.from_tree(_restore_like(node.tree(), restored, prefix))
    if not isinstance(node, dict):
        return restored[prefix]
    return {key: _restore_like(value, restored, f"{prefix}/{key}" if prefix else key)
            for key, value in node.items()}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _write_npy(path: Path, arr: np.ndarray) -> None:
    with open(path, "wb") as f:
        np.save(f, arr)
        f.flush()
        os.fsync(f.fileno())


def save_sharded(path: str | Path, state) -> Path:
    """Write ``state`` (a pytree of ``ShardedTensor`` and scalar leaves,
    or a ``ShardedCLIP`` / ``ShardedAdamState``, or a dict of them) in the
    port's sharded format; returns the directory. A directory of this
    format already at ``path`` is replaced; any other non-empty one is
    refused."""
    from ..parallel.mesh import ShardedTensor  # parallel/ imports index/, which imports models/

    path = Path(path).resolve()
    if path.exists() and any(path.iterdir()) and not (path / _MANIFEST).exists():
        raise FileExistsError(f"{path} holds something else than a sharded checkpoint")
    tmp = path.with_name(path.name + ".partial")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    leaves, mesh_shape = [], None
    for i, (key, leaf) in enumerate(sorted(tree_items(state).items())):
        if not isinstance(leaf, ShardedTensor):
            leaves.append({"key": key, "value": int(leaf) if isinstance(leaf, (int, np.integer))
                           else float(leaf)})
            continue
        mesh_shape = mesh_shape or list(leaf.sharding.mesh.shape.items())
        shards = []
        for j, group in enumerate(leaf.sharding.groups(leaf.shape)):
            shard = leaf.shards[group[0]].detach()
            if shard.dtype == torch.bfloat16:
                shard = shard.view(torch.int16)
            name = f"{i:04d}.{j}.npy"
            _write_npy(tmp / name, shard.cpu().numpy())
            index = leaf.sharding.index(leaf.shape, group[0])
            shards.append({"file": name, "index": [[s.start, s.stop] for s in index]})
        leaves.append({"key": key, "shape": list(leaf.shape), "dtype": _dtype_name(leaf.dtype),
                       "spec": list(leaf.sharding.spec), "shards": shards})
    manifest = {"format": SHARDED_FORMAT, "version": SHARDED_VERSION,
                "mesh": mesh_shape, "leaves": leaves}
    with open(tmp / _MANIFEST, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if path.exists():
        shutil.rmtree(path)
    tmp.rename(path)
    return path


def _read_manifest(path: Path) -> dict:
    if not (path / _MANIFEST).exists():
        if any((path / marker).exists() for marker in _ORBAX_MARKERS):
            raise ValueError(
                f"{path} is an orbax checkpoint (the JAX package's save_sharded); the "
                "port reads only its own sharded format. Exchange training state "
                "between the packages through clip.npz and train_state.npz")
        raise FileNotFoundError(f"{path} is not a sharded checkpoint (no {_MANIFEST})")
    manifest = json.loads((path / _MANIFEST).read_text())
    if manifest.get("format") != SHARDED_FORMAT or manifest.get("version") != SHARDED_VERSION:
        raise ValueError(f"{path}: unknown sharded format "
                         f"{manifest.get('format')!r} version {manifest.get('version')!r}")
    return manifest


def _open_shard(path: Path, entry: dict, dtype: str) -> np.ndarray:
    """One shard file, memory-mapped, checked against its manifest entry."""
    file = path / entry["file"]
    want = tuple(b - a for a, b in entry["index"])
    try:
        arr = np.load(file, mmap_mode="r", allow_pickle=False)
    except FileNotFoundError as e:
        raise FileNotFoundError(f"sharded checkpoint {path}: shard {entry['file']} is missing") from e
    except ValueError as e:  # a short file cannot be mapped
        raise ValueError(f"sharded checkpoint {path}: shard {entry['file']} is short or "
                         f"damaged ({e})") from e
    width = np.dtype(np.int16 if dtype == "bfloat16" else dtype)
    if arr.shape != want or arr.dtype != width:
        raise ValueError(f"sharded checkpoint {path}: shard {entry['file']} holds "
                         f"{arr.dtype}{arr.shape}, the manifest says {width}{want}")
    return arr


def load_sharded(path: str | Path, target):
    """Restore the state ``save_sharded`` wrote into ``target``'s
    structure and placements: ``target`` is built like the saved state,
    its leaves ``ShardedTensor``s (abstract ones will do) whose shardings
    may lie on another (data, model) mesh shape than the saved one's. Each
    target shard is assembled straight on its device from the memory-
    mapped slices of the saved shards it overlaps, so no full-size host
    copy of a sharded leaf is made. Raises on an orbax directory, a
    missing or short shard file, and a leaf whose key, shape or dtype
    does not match."""
    from ..parallel.mesh import ShardedTensor  # parallel/ imports index/, which imports models/

    path = Path(path).resolve()
    manifest = _read_manifest(path)
    saved = {leaf["key"]: leaf for leaf in manifest["leaves"]}
    restored = {}
    for key, like in tree_items(target).items():
        if key not in saved:
            raise KeyError(f"sharded checkpoint {path} has no leaf {key!r}")
        entry = saved[key]
        if not isinstance(like, ShardedTensor):
            restored[key] = entry["value"]
            continue
        if tuple(entry["shape"]) != tuple(like.shape) or entry["dtype"] != _dtype_name(like.dtype):
            raise ValueError(f"{key}: saved {entry['dtype']}{entry['shape']}, the target is "
                             f"{_dtype_name(like.dtype)}{list(like.shape)}")
        files = [(s, _open_shard(path, s, entry["dtype"])) for s in entry["shards"]]
        sharding = like.sharding
        shards: list = [None] * sharding.mesh.size
        for group in sharding.groups(like.shape):
            want = sharding.index(like.shape, group[0])
            first = _assemble(path, key, like.dtype, want, files, sharding.mesh.device(group[0]))
            shards[group[0]] = first
            for pos in group[1:]:
                shards[pos] = torch.empty_like(first, device=sharding.mesh.device(pos)).copy_(first)
        restored[key] = ShardedTensor(sharding, tuple(like.shape), like.dtype, shards)
    return _restore_like(target, restored)


def _assemble(path: Path, key: str, dtype: torch.dtype, want: tuple[slice, ...],
              files: list, device: torch.device) -> torch.Tensor:
    """The ``want`` slice of leaf ``key`` on ``device``, copied piece by
    piece from the saved shards that overlap it."""
    out = torch.empty(tuple(s.stop - s.start for s in want), dtype=dtype, device=device)
    covered = 0
    for entry, arr in files:
        lo = [max(w.start, a) for w, (a, _) in zip(want, entry["index"])]
        hi = [min(w.stop, b) for w, (_, b) in zip(want, entry["index"])]
        if any(a >= b for a, b in zip(lo, hi)):
            continue
        src = np.array(arr[tuple(slice(a - s, b - s) for a, b, (s, _)
                                 in zip(lo, hi, entry["index"]))])
        piece = torch.from_numpy(src)
        if dtype == torch.bfloat16:
            piece = piece.view(torch.bfloat16)
        out[tuple(slice(a - w.start, b - w.start) for a, b, w in zip(lo, hi, want))] = piece
        covered += int(np.prod([b - a for a, b in zip(lo, hi)]))
    if covered != out.numel():
        raise ValueError(f"sharded checkpoint {path}: the shards of {key} do not cover "
                         f"the slice {[(s.start, s.stop) for s in want]}")
    return out
