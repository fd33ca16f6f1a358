"""The port's sharded checkpoint format (``models.checkpoint.save_sharded``
/ ``load_sharded``) on ``[cpu] * 8``: a mesh run's params and Adam state
round-trip bit for bit onto the same (4, 2) mesh and onto (2, 4) and
(8, 1); each distinct slice is written once; a missing or short shard
file raises; and an orbax directory written by the JAX package's
``save_sharded`` is refused, as the port never reads it."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from evossearch_tpu.core.constants import CLIPModelSpec as RefSpec
from evossearch_tpu.models import init_params
from evossearch_tpu.models.checkpoint import save_sharded as ref_save_sharded
from evossearch_tpu.train import clip_param_shardings as ref_param_shardings
from evossearch_tpu.train import train_mesh as ref_train_mesh
from evossearch_tpu_torch.core import CLIPModelSpec
from evossearch_tpu_torch.models.checkpoint import _flatten, load_sharded, save_sharded
from evossearch_tpu_torch.train import (
    ShardedAdamState,
    ShardedCLIP,
    make_optimizer,
    make_train_step,
    train_mesh,
)

TINY = CLIPModelSpec(
    name="tiny", image_size=32, patch_size=16, vision_width=64,
    vision_layers=2, vision_heads=4, text_width=64, text_layers=2,
    text_heads=4, vocab_size=256, context_length=16, embed_dim=32,
)
REF_TINY = RefSpec(**dataclasses.asdict(TINY))


def _mesh(data, model):
    return train_mesh(devices=["cpu"] * (data * model), model_parallel=model)


@pytest.fixture(scope="module")
def trained():
    """A (4, 2) mesh run two steps in: its params and Adam state."""
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.standard_normal((8, 32, 32, 3)).astype(np.float32))
    tokens = np.zeros((8, 16), np.int64)
    tokens[:, 0] = 1
    tokens[:, 1:8] = rng.integers(2, 254, (8, 7))
    tokens[:, 8] = 255
    params = jax.device_get(init_params(jax.random.key(0), REF_TINY))
    model = ShardedCLIP.place(params, _mesh(4, 2), TINY)
    opt = make_optimizer(learning_rate=1e-3)
    state = opt.init(model)
    step = make_train_step(TINY, opt)
    for _ in range(2):
        step(model, state, images, torch.from_numpy(tokens))
    return model, state


@pytest.fixture()
def saved(trained, tmp_path):
    model, state = trained
    return save_sharded(tmp_path / "ckpt", {"params": model, "opt_state": state})


def _leaves(model, state):
    return {**{f"params/{k}": v for k, v in model.params.items()},
            **{f"mu/{k}": v for k, v in state.mu.items()},
            **{f"nu/{k}": v for k, v in state.nu.items()}}


def test_round_trip_on_the_same_mesh(trained, saved):
    model, state = trained
    got = load_sharded(saved, {"params": model, "opt_state": state})
    g_model, g_state = got["params"], got["opt_state"]
    assert isinstance(g_model, ShardedCLIP) and isinstance(g_state, ShardedAdamState)
    assert g_state.count == state.count == 2
    want = _leaves(model, state)
    got = _leaves(g_model, g_state)
    assert set(got) == set(want)
    storages = set()
    for key, leaf in want.items():
        assert got[key].sharding == leaf.sharding and got[key].shape == leaf.shape
        for a, b in zip(got[key].shards, leaf.shards):
            assert torch.equal(a, b), key
            storages.add(a.untyped_storage().data_ptr())
    assert len(storages) == sum(len(v.shards) for v in got.values())
    assert all(s.requires_grad for leaf in g_model.params.values() for s in leaf.shards)


@pytest.mark.parametrize("shape", [(2, 4), (8, 1)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_restore_onto_another_mesh_shape(trained, saved, shape):
    """Into an abstract target on another (data, model) shape: every
    position holds its slice of the saved values, bit for bit, and the
    restored run takes a step."""
    model, state = trained
    target = ShardedCLIP.abstract(TINY, _mesh(*shape))
    got = load_sharded(saved, {"params": target, "opt_state": ShardedAdamState.abstract(target)})
    g_model, g_state = got["params"], got["opt_state"]
    assert g_model.mesh.shape == {"data": shape[0], "model": shape[1]}
    for key, leaf in _leaves(g_model, g_state).items():
        whole = _leaves(model, state)[key].gather()
        for pos, shard in enumerate(leaf.shards):
            assert torch.equal(shard, whole[leaf.sharding.index(leaf.shape, pos)]), (key, pos)
    assert g_state.count == 2


def test_each_distinct_slice_is_written_once(trained, saved):
    manifest = json.loads((saved / "manifest.json").read_text())
    assert manifest["format"] == "evossearch_tpu_torch.sharded" and manifest["version"] == 1
    assert manifest["mesh"] == [["data", 4], ["model", 2]]
    model, state = trained
    entries = {e["key"]: e for e in manifest["leaves"]}
    assert entries["opt_state/count"]["value"] == 2
    files = set()
    for key, leaf in model.params.items():
        entry = entries[f"params/{key}"]
        split = "model" in leaf.sharding.spec
        assert len(entry["shards"]) == (2 if split else 1), key
        assert entry["spec"] == list(leaf.sharding.spec)
        for shard in entry["shards"]:
            arr = np.load(saved / shard["file"])
            assert arr.shape == tuple(b - a for a, b in shard["index"])
            files.add(shard["file"])
    assert sorted(p.name for p in saved.glob("*.npy")) == sorted(
        s["file"] for e in manifest["leaves"] for s in e.get("shards", []))
    assert len(files) == sum(len(leaf.sharding.groups(leaf.shape))
                             for leaf in model.params.values())


@pytest.mark.parametrize("damage", ["missing", "short"])
def test_a_missing_or_short_shard_raises(trained, saved, damage):
    model, state = trained
    entry = next(e for e in json.loads((saved / "manifest.json").read_text())["leaves"]
                 if e["key"] == "params/visual/blocks/attn/wqkv")
    victim = saved / entry["shards"][1]["file"]
    if damage == "missing":
        victim.unlink()
        with pytest.raises(FileNotFoundError, match=f"{victim.name} is missing"):
            load_sharded(saved, {"params": model, "opt_state": state})
    else:
        victim.write_bytes(victim.read_bytes()[:-100])
        with pytest.raises(ValueError, match=f"{victim.name} is short"):
            load_sharded(saved, {"params": model, "opt_state": state})


def test_a_wrong_target_raises(trained, saved):
    other = dataclasses.replace(TINY, embed_dim=16)
    with pytest.raises(ValueError, match="saved float32"):
        load_sharded(saved, {"params": ShardedCLIP.abstract(other, _mesh(4, 2))})
    with pytest.raises(FileExistsError, match="something else"):
        (saved.parent / "other").mkdir()
        (saved.parent / "other" / "notes.txt").write_text("keep")
        save_sharded(saved.parent / "other", trained[0])


def test_the_jax_packages_orbax_directory_is_refused(tmp_path):
    """Neither package reads the other's sharded directory: the port
    refuses an orbax checkpoint with a clear error (the exchange goes
    through clip.npz and train_state.npz)."""
    params = jax.device_get(init_params(jax.random.key(0), REF_TINY))
    mesh = ref_train_mesh(model_parallel=2)
    ref_save_sharded(tmp_path / "orbax", jax.device_put(params, ref_param_shardings(mesh)))
    target = ShardedCLIP.abstract(TINY, _mesh(4, 2))
    with pytest.raises(ValueError, match="orbax checkpoint.*clip.npz and train_state.npz"):
        load_sharded(tmp_path / "orbax", target)
    with pytest.raises(FileNotFoundError, match="not a sharded checkpoint"):
        load_sharded(tmp_path, target)


def test_params_alone_round_trip(trained, tmp_path):
    model, _ = trained
    path = save_sharded(tmp_path / "params", model)
    got = load_sharded(path, ShardedCLIP.abstract(TINY, _mesh(4, 2)))
    want, have = _flatten(model.to_numpy()), _flatten(got.to_numpy())
    assert all(np.array_equal(want[k], have[k]) for k in want)
