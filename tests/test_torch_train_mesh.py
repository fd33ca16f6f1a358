"""The mesh half of training: the port's (data, model) mesh on
``[cpu] * 8`` against the JAX package's ``train_mesh`` on the conftest's
8 forced host devices (``tests/test_train.py``'s tiny spec and batch):
the mesh's shape and refusal, the specs leaf for leaf, every shard
against the JAX array's addressable shard, one sharded step against the
port's one-device step and JAX's sharded step (the JAX package's own
rule: loss within 1e-5, params within 2e-5 at lr 1e-3), the reduced
gradients against the one-device ones, replicated copies after several
steps, bf16, and ``fit`` on a mesh resumed across packages and meshes."""

import copy
import dataclasses
import shutil

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from evossearch_tpu.core.constants import CLIPModelSpec as RefSpec
from evossearch_tpu.models import init_params
from evossearch_tpu.tokenizer import CLIPTokenizer as RefTokenizer
from evossearch_tpu.train import batch_shardings as ref_batch_shardings
from evossearch_tpu.train import clip_param_shardings as ref_param_shardings
from evossearch_tpu.train import clip_param_specs as ref_param_specs
from evossearch_tpu.train import make_optimizer as ref_make_optimizer
from evossearch_tpu.train import make_train_step as ref_make_train_step
from evossearch_tpu.train import train_mesh as ref_train_mesh
from evossearch_tpu.train.data import PairDataset as RefPairDataset
from evossearch_tpu.train.loop import fit as ref_fit
from evossearch_tpu_torch.core import CLIPModelSpec
from evossearch_tpu_torch.models import params_from_numpy, params_to_numpy
from evossearch_tpu_torch.models.checkpoint import (
    _flatten,
    load_params,
    tree_from_named,
    tree_items,
)
from evossearch_tpu_torch.tokenizer import CLIPTokenizer
from evossearch_tpu_torch.train import (
    DATA_AXIS,
    MODEL_AXIS,
    PairDataset,
    ShardedCLIP,
    batch_shardings,
    clip_loss,
    clip_param_shardings,
    clip_param_specs,
    fit,
    make_optimizer,
    make_train_step,
    train_mesh,
)
from evossearch_tpu_torch.train.sharded import reduce_gradients
from test_torch_train_loop import RESUME_RTOL, _pair_folder

TINY = CLIPModelSpec(
    name="tiny", image_size=32, patch_size=16, vision_width=64,
    vision_layers=2, vision_heads=4, text_width=64, text_layers=2,
    text_heads=4, vocab_size=256, context_length=16, embed_dim=32,
)
REF_TINY = RefSpec(**dataclasses.asdict(TINY))
# tests/test_train_loop.py's spec (the tokenizer's vocab) for fit
TINY_FIT = dataclasses.replace(TINY, vocab_size=49408, context_length=16)
REF_TINY_FIT = RefSpec(**dataclasses.asdict(TINY_FIT))
LOSS_ATOL, PARAM_ATOL = 1e-5, 2e-5  # tests/test_train.py:70-72
# float32, one graph split over positions: the summation order of the
# split products and of the gradient sums differs (tests/test_torch_train.py)
RTOL, LEAF_ATOL = 1e-4, 1e-5
MESHES = [(8, 1), (4, 2), (2, 4)]


def _batch(n=8):
    rng = np.random.default_rng(0)
    images = rng.standard_normal((n, 32, 32, 3)).astype(np.float32)
    tokens = np.zeros((n, 16), np.int32)
    tokens[:, 0] = 1
    tokens[:, 1:8] = rng.integers(2, 254, (n, 7))
    tokens[:, 8] = 255  # eot = max id
    return images, tokens


def _mesh(data, model):
    return train_mesh(devices=["cpu"] * (data * model), model_parallel=model)


@pytest.fixture(scope="module")
def params():
    return jax.device_get(init_params(jax.random.key(1), REF_TINY))


@pytest.fixture(scope="module")
def one_device_step(params):
    """The port's one-device step: (loss, params after it)."""
    images, tokens = _batch()
    model = params_from_numpy(params, TINY, "cpu")
    opt = make_optimizer(learning_rate=1e-3)
    loss = make_train_step(TINY, opt)(model, opt.init(model), torch.from_numpy(images),
                                      torch.from_numpy(tokens))
    return float(loss), _flatten(params_to_numpy(model))


@pytest.fixture(scope="module")
def jax_sharded_steps(params):
    """JAX's sharded step on each mesh shape: (loss, params after it)."""
    images, tokens = _batch()
    opt = ref_make_optimizer(learning_rate=1e-3)
    step = jax.jit(ref_make_train_step(REF_TINY, opt))
    out = {}
    for data, model in MESHES:
        mesh = ref_train_mesh(model_parallel=model)
        assert dict(mesh.shape) == {"data": data, "model": model}
        sharded = jax.device_put(params, ref_param_shardings(mesh))
        img_s, tok_s = ref_batch_shardings(mesh)
        p, _, loss = step(sharded, opt.init(sharded), jax.device_put(images, img_s),
                          jax.device_put(tokens, tok_s))
        out[(data, model)] = float(loss), _flatten(jax.device_get(p))
    return out


@pytest.mark.parametrize("n,tp,shape", [(8, 1, (8, 1)), (8, 2, (4, 2)), (8, 4, (2, 4)),
                                        (4, 4, (1, 4)), (6, 3, (2, 3))])
def test_train_mesh_shapes(n, tp, shape):
    mesh = train_mesh(devices=["cpu"] * 8, n_devices=n, model_parallel=tp)
    ref = ref_train_mesh(n_devices=n, model_parallel=tp)
    assert mesh.axis_names == tuple(ref.axis_names) == (DATA_AXIS, MODEL_AXIS)
    assert mesh.shape == dict(ref.shape) == dict(zip((DATA_AXIS, MODEL_AXIS), shape))
    assert mesh.size == n and all(d.type == "cpu" for row in mesh.devices for d in row)


def test_train_mesh_refuses_an_uneven_split():
    with pytest.raises(ValueError, match="not divisible"):
        ref_train_mesh(model_parallel=3)
    with pytest.raises(ValueError, match="not divisible"):
        train_mesh(devices=["cpu"] * 8, model_parallel=3)


def test_param_specs_equal_jax_leaf_for_leaf():
    want = {
        "/".join(k.key for k in path): tuple(spec)
        for path, spec in jax.tree_util.tree_flatten_with_path(
            ref_param_specs(), is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    }
    assert tree_items(clip_param_specs()) == want
    assert set(tree_items(clip_param_shardings(_mesh(4, 2)))) == set(want)
    images, tokens = batch_shardings(_mesh(4, 2))
    ref_images, ref_tokens = ref_batch_shardings(ref_train_mesh(model_parallel=2))
    assert (images.spec, tokens.spec) == (tuple(ref_images.spec), tuple(ref_tokens.spec))


def test_every_shard_is_the_jax_arrays_addressable_shard(params):
    """On the (4, 2) mesh: each position holds the slice (bounds and
    values) the JAX array's shard holds on the device at the same
    position, in its own storage of the slice's shape."""
    mesh = _mesh(4, 2)
    model = ShardedCLIP.place(params, mesh, TINY)
    ref_mesh = ref_train_mesh(model_parallel=2)
    ref = tree_items(jax.device_put(params, ref_param_shardings(ref_mesh)))
    assert set(ref) == set(model.params)
    storages = set()
    for key, leaf in model.params.items():
        assert leaf.shape == ref[key].shape
        for shard in ref[key].addressable_shards:
            (row, col), = np.argwhere(ref_mesh.devices == shard.device)
            pos = row * 2 + col
            got = leaf.shards[pos]
            want_index = tuple(slice(*s.indices(n)[:2]) for s, n in zip(shard.index, leaf.shape))
            assert leaf.sharding.index(leaf.shape, pos) == want_index, key
            np.testing.assert_array_equal(got.detach().numpy(), np.asarray(shard.data))
            assert got.is_contiguous() and got.requires_grad and got.grad_fn is None
            storages.add(got.untyped_storage().data_ptr())
    assert len(storages) == sum(len(leaf.shards) for leaf in model.params.values())


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_step_matches_one_device_and_jax(params, one_device_step, jax_sharded_steps,
                                                 shape, remat):
    images, tokens = _batch()
    model = ShardedCLIP.place(params, _mesh(*shape), TINY)
    opt = make_optimizer(learning_rate=1e-3)
    state = opt.init(model)
    loss = float(make_train_step(TINY, opt, remat=remat)(
        model, state, torch.from_numpy(images), torch.from_numpy(tokens)))
    got = _flatten(model.to_numpy())
    assert state.count == 1
    for want_loss, want in (one_device_step, jax_sharded_steps[shape]):
        assert abs(loss - want_loss) < LOSS_ATOL
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_allclose(got[key], np.asarray(want[key]), atol=PARAM_ATOL,
                                       rtol=0, err_msg=key)


def _one_device_grads(params, dtype):
    images, tokens = _batch()
    model = params_from_numpy(params, TINY, "cpu")
    loss = clip_loss(model, torch.from_numpy(images), torch.from_numpy(tokens), dtype)
    loss.backward()
    return float(loss.detach()), _flatten(tree_from_named(
        {n: p.grad.double().numpy() for n, p in model.named_parameters()}))


def _sharded_grads(params, shape, dtype):
    images, tokens = _batch()
    model = ShardedCLIP.place(params, _mesh(*shape), TINY)
    loss = clip_loss(model, torch.from_numpy(images), torch.from_numpy(tokens), dtype)
    loss.backward()
    norm = reduce_gradients(model)
    return float(loss.detach()), {k: g.double().numpy() for k, g in model.gather_grads().items()}, float(norm)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_reduced_gradients_equal_one_device(params, shape):
    """Every leaf's gradient, summed over its holders, is the one-device
    gradient; the norm counts each element once (a sum over replicas
    would grow it by the data width)."""
    want_loss, want = _one_device_grads(params, torch.float32)
    loss, got, norm = _sharded_grads(params, shape, torch.float32)
    assert abs(loss - want_loss) < LOSS_ATOL
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=RTOL, atol=LEAF_ATOL * np.abs(w).max(),
                                   err_msg=key)
    want_norm = np.sqrt(sum(np.sum(w * w) for w in want.values()))
    assert norm == pytest.approx(want_norm, rel=1e-5)


def test_bf16_sharded_gradients_agree_by_cosine(params):
    """bf16 rounds the split products' activations at other places: per
    leaf, the (4, 2) gradients agree with the one-device bf16 ones by
    cosine (the smoke's bf16 rule)."""
    _, want = _one_device_grads(params, torch.bfloat16)
    _, got, _ = _sharded_grads(params, (4, 2), torch.bfloat16)
    for key, w in want.items():
        g, w = got[key].ravel(), w.ravel()
        assert g @ w / (np.linalg.norm(g) * np.linalg.norm(w)) >= 0.99, key


def test_replicated_copies_stay_bit_equal(params):
    """After 3 steps on (4, 2), the positions that hold the same slice of
    a param or of a moment hold equal bits."""
    images, tokens = _batch()
    model = ShardedCLIP.place(params, _mesh(4, 2), TINY)
    opt = make_optimizer(learning_rate=1e-3)
    state = opt.init(model)
    step = make_train_step(TINY, opt)
    for _ in range(3):
        step(model, state, torch.from_numpy(images), torch.from_numpy(tokens))
    assert state.count == 3
    for leaves in (model.params, state.mu, state.nu):
        for key, leaf in leaves.items():
            for group in leaf.sharding.groups(leaf.shape):
                first = leaf.shards[group[0]]
                assert all(torch.equal(first, leaf.shards[p]) for p in group[1:]), key
    assert not np.array_equal(model.params["visual/ln_pre/scale"].shards[0].detach().numpy(),
                              params["visual"]["ln_pre"]["scale"])


def test_sharded_model_gathers_back(params):
    model = ShardedCLIP.place(params, _mesh(2, 4), TINY)
    for key, value in _flatten(params).items():
        np.testing.assert_array_equal(_flatten(model.to_numpy())[key], value)
    one = params_from_numpy(params, TINY, "cpu")
    placed = ShardedCLIP.place(one, _mesh(2, 4))
    for key, leaf in placed.params.items():
        assert all(torch.equal(a, b) for a, b in zip(leaf.shards, model.params[key].shards))
    gathered = model.gather("cpu")
    for (name, a), (_, b) in zip(gathered.named_parameters(), one.named_parameters()):
        assert torch.equal(a, b), name


# ---------------------------------------------------------------- fit


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """One epoch from one JAX init: the port on the (4, 2) mesh, the JAX
    package on its (4, 2) mesh, the port on one device."""
    root = tmp_path_factory.mktemp("mesh_runs")
    (root / "photos").mkdir()
    folder = _pair_folder(root / "photos")
    init = jax.device_get(init_params(jax.random.key(5), REF_TINY_FIT))
    _, jax_history = ref_fit(
        REF_TINY_FIT, RefPairDataset(folder, RefTokenizer(), REF_TINY_FIT, batch_size=8, seed=4),
        epochs=1, learning_rate=1e-3, params=init, checkpoint_dir=root / "jax_mesh",
        mesh=ref_train_mesh(model_parallel=2), log_every=100)
    histories = {"jax_mesh": jax_history}
    for name, mesh in (("port_mesh", _mesh(4, 2)), ("port_one", None)):
        _, histories[name] = fit(
            TINY_FIT, PairDataset(folder, CLIPTokenizer(), TINY_FIT, batch_size=8, seed=4),
            epochs=1, learning_rate=1e-3, params=params_from_numpy(copy.deepcopy(init), TINY_FIT,
                                                                    "cpu"),
            checkpoint_dir=root / name, mesh=mesh, log_every=100, device="cpu")
    return root, folder, histories


def test_fit_on_a_mesh_agrees_with_jax_and_one_device(mesh_runs):
    """The counterpart of tests/test_train_loop.py:test_fit_sharded_mesh,
    held to the other runs from the same init: the loss, and clip.npz
    leaf for leaf (RMS within 1% of a step, as
    tests/test_torch_train_loop.py holds the two packages' one-device
    runs)."""
    root, _, histories = mesh_runs
    assert np.isfinite(histories["port_mesh"][0])
    np.testing.assert_allclose(histories["port_mesh"], histories["jax_mesh"], rtol=RESUME_RTOL)
    np.testing.assert_allclose(histories["port_mesh"], histories["port_one"], rtol=RESUME_RTOL)
    got, spec = load_params(root / "port_mesh" / "clip.npz")
    assert spec == TINY_FIT
    got = _flatten(got)
    for other in ("jax_mesh", "port_one"):
        want = _flatten(load_params(root / other / "clip.npz")[0])
        assert set(got) == set(want)
        for key in want:
            assert np.sqrt(np.mean((got[key] - want[key]) ** 2)) <= 0.01 * 1e-3, (other, key)
    with np.load(root / "port_mesh" / "train_state.npz") as g, \
            np.load(root / "jax_mesh" / "train_state.npz") as w:
        assert sorted(g.files) == sorted(w.files)
        for key in w.files:
            assert (g[key].shape, g[key].dtype) == (w[key].shape, w[key].dtype), key
        assert int(g["opt_0"]) == 2 and int(g["epoch"]) == 0


def _resume(folder, ckpt, where):
    """One resumed epoch of the run in ``ckpt``: the port on one device or
    on the (2, 4) mesh, or the JAX package on one device. Returns the loss
    history. (The JAX package's ``fit`` cannot resume on a mesh: it puts
    the restored Adam count on one device, which its sharded step
    refuses; ROADMAP C.)"""
    if where == "jax_one":
        return ref_fit(REF_TINY_FIT, RefPairDataset(folder, RefTokenizer(), REF_TINY_FIT,
                                                    batch_size=8, seed=6),
                       epochs=1, learning_rate=1e-3, checkpoint_dir=ckpt, resume=True,
                       log_every=100)[1]
    mesh = _mesh(2, 4) if where == "port_mesh" else None
    return fit(TINY_FIT, PairDataset(folder, CLIPTokenizer(), TINY_FIT, batch_size=8, seed=6),
               epochs=1, learning_rate=1e-3, checkpoint_dir=ckpt, resume=True, mesh=mesh,
               log_every=100, device="cpu")[1]


@pytest.mark.parametrize("writer,readers", [
    ("port_mesh", ("port_one", "jax_one", "port_mesh")),
    ("jax_mesh", ("jax_one", "port_one", "port_mesh")),
    ("port_one", ("port_one", "port_mesh")),
])
def test_a_mesh_run_resumes_anywhere(mesh_runs, tmp_path, writer, readers):
    """A run written on a mesh resumes on one device and in the JAX
    package, and a one-device run resumes on a mesh: every resumption of
    one checkpoint directory gives the same loss, restores the saved
    optimizer state and numbers the epoch after the saved one."""
    root, folder, _ = mesh_runs
    losses = {}
    for reader in readers:
        shutil.copytree(root / writer, tmp_path / reader)
        losses[reader] = _resume(folder, tmp_path / reader, reader)
        with np.load(tmp_path / reader / "train_state.npz") as data:
            assert int(data["epoch"]) == 1 and int(data["opt_0"]) == 4, reader
    first = losses[readers[0]]
    for reader in readers[1:]:
        np.testing.assert_allclose(losses[reader], first, rtol=RESUME_RTOL, err_msg=reader)
