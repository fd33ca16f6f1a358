"""The port's training loop against the JAX package's on tiny data
(``tests/test_train_loop.py``'s spec and folder): loss decreases,
checkpoints round-trip, resume works, retrieval accuracy improves over
random; PairDataset yields the JAX package's batches; both checkpoint
files cross between the packages, and a run written by either package
resumes in the other with the same first loss."""

import dataclasses
import json
import shutil

import jax
import numpy as np
import pytest
from PIL import Image

from evossearch_tpu.core.constants import CLIPModelSpec as RefSpec
from evossearch_tpu.models import init_params
from evossearch_tpu.models.checkpoint import load_params as ref_load_params
from evossearch_tpu.tokenizer import CLIPTokenizer as RefTokenizer
from evossearch_tpu.train.data import PairDataset as RefPairDataset
from evossearch_tpu.train.loop import fit as ref_fit
from evossearch_tpu_torch.core import CLIPModelSpec
from evossearch_tpu_torch.models import load_model, params_from_numpy, params_to_numpy
from evossearch_tpu_torch.models.checkpoint import load_params, tree_leaves
from evossearch_tpu_torch.tokenizer import CLIPTokenizer
from evossearch_tpu_torch.train import PairDataset, fit, retrieval_accuracy, train_mesh

TINY = CLIPModelSpec(
    name="tiny", image_size=32, patch_size=16, vision_width=64,
    vision_layers=2, vision_heads=4, text_width=64, text_layers=2,
    text_heads=4, vocab_size=49408, context_length=16, embed_dim=32,
)
REF_TINY = RefSpec(**dataclasses.asdict(TINY))
# one resumed epoch (two steps) from one checkpoint in each package: the
# same data and state, float32 summation order only
RESUME_RTOL = 1e-4


def _pair_folder(root):
    rng = np.random.default_rng(0)
    captions = {}
    colors = {"red": (200, 30, 30), "green": (30, 200, 30),
              "blue": (30, 30, 200), "yellow": (200, 200, 30)}
    i = 0
    for name, rgb in colors.items():
        for _ in range(4):
            arr = np.full((48, 48, 3), rgb, np.uint8)
            arr = (arr + rng.normal(0, 12, arr.shape)).clip(0, 255).astype(np.uint8)
            fname = f"img_{i:03d}.jpg"
            Image.fromarray(arr).save(root / fname, quality=92)
            captions[fname] = f"a {name} square"
            i += 1
    (root / "captions.json").write_text(json.dumps(captions))
    return root


@pytest.fixture()
def pair_folder(tmp_path):
    return _pair_folder(tmp_path)


def test_fit_decreases_loss_and_checkpoints(pair_folder, tmp_path):
    ds = PairDataset(pair_folder, CLIPTokenizer(), TINY, batch_size=8, seed=0)
    assert len(ds) == 2
    model, history = fit(TINY, ds, epochs=6, learning_rate=3e-3,
                         checkpoint_dir=tmp_path / "ck", log_every=100, device="cpu")
    assert history[-1] < history[0]
    assert (tmp_path / "ck" / "clip.npz").exists()
    # the trained model retrieves the right caption within a batch far
    # better than chance (1/8)
    acc = retrieval_accuracy(model, TINY, ds.epoch())
    assert acc > 0.3, acc


def test_fit_resume_from_checkpoint(pair_folder, tmp_path):
    ds = PairDataset(pair_folder, CLIPTokenizer(), TINY, batch_size=8, seed=1)
    fit(TINY, ds, epochs=1, learning_rate=1e-3, checkpoint_dir=tmp_path / "ck",
        log_every=100, device="cpu")
    saved, _ = load_params(tmp_path / "ck" / "clip.npz")
    # resume with lr=0: the returned params equal the checkpoint exactly,
    # so fit() started from it, not from a fresh init
    model, _ = fit(TINY, ds, epochs=1, learning_rate=0.0, checkpoint_dir=tmp_path / "ck",
                   resume=True, log_every=100, device="cpu")
    for a, b in zip(tree_leaves(saved), tree_leaves(params_to_numpy(model))):
        np.testing.assert_allclose(a, b, atol=1e-7)


def test_fit_sharded_mesh(pair_folder):
    """fit on the (4, 2) mesh over [cpu] * 8, the stand-in for the JAX
    test's 8 forced host devices: a finite loss, and a sharded model."""
    ds = PairDataset(pair_folder, CLIPTokenizer(), TINY, batch_size=8, seed=2)
    mesh = train_mesh(devices=["cpu"] * 8, model_parallel=2)
    model, history = fit(TINY, ds, epochs=1, learning_rate=1e-3, mesh=mesh, log_every=100)
    assert np.isfinite(history[0])
    assert model.mesh is mesh and model.mesh.shape == {"data": 4, "model": 2}


def test_dataset_skips_missing_and_corrupt(pair_folder):
    (pair_folder / "img_000.jpg").write_bytes(b"broken")
    captions = json.loads((pair_folder / "captions.json").read_text())
    captions["ghost.jpg"] = "not on disk"
    (pair_folder / "captions.json").write_text(json.dumps(captions))
    ds = PairDataset(pair_folder, CLIPTokenizer(), TINY, batch_size=8, seed=0)
    batches = list(ds.epoch())
    total = sum(b[0].shape[0] for b in batches)
    assert 0 < total <= 15  # corrupt one skipped, ghost not listed


def test_fit_resume_restores_optimizer_state(pair_folder, tmp_path, monkeypatch):
    """resume=True restores the Adam moments alongside the params, and
    numbers the epochs after the saved one."""
    import evossearch_tpu_torch.train.loop as loop_mod

    ds = PairDataset(pair_folder, CLIPTokenizer(), TINY, batch_size=8, seed=0)
    fit(TINY, ds, epochs=1, checkpoint_dir=tmp_path, device="cpu")
    with np.load(tmp_path / "train_state.npz") as data:
        moment_norms = [float(np.abs(data[k]).sum()) for k in data.files if k != "epoch"]
        assert int(data["epoch"]) == 0
    assert any(n > 0 for n in moment_norms)  # real moments persisted

    restored = {}
    real = loop_mod._load_train_state

    def spy(path, model):
        out = real(path, model)
        restored["count"] = None if out[0] is None else out[0].count
        return out

    monkeypatch.setattr(loop_mod, "_load_train_state", spy)
    fit(TINY, ds, epochs=1, checkpoint_dir=tmp_path, resume=True, device="cpu")
    assert restored.get("count") == 2  # the saved state, not a fresh one
    with np.load(tmp_path / "train_state.npz") as data:
        assert int(data["epoch"]) == 1 and int(data["opt_0"]) == 4


def test_dataset_static_batches_across_mixed_sizes(tmp_path):
    """A mixed-size captioned folder yields EXACTLY batch_size rows per
    batch with ONE unique canonical size (static shapes for the step)."""
    rng = np.random.default_rng(0)
    captions = {}
    for i in range(10):
        fname = f"m{i}.jpg"
        arr = rng.integers(0, 256, (40 + 3 * i, 52 + 5 * i, 3), dtype=np.uint8)
        Image.fromarray(arr).save(tmp_path / fname, quality=92)
        captions[fname] = f"photo {i}"
    (tmp_path / "captions.json").write_text(json.dumps(captions))
    ds = PairDataset(tmp_path, CLIPTokenizer(), TINY, batch_size=4, seed=0)
    shapes = set()
    for canv, a_h, a_w, idx, tokens in ds.epoch():
        assert canv.shape[0] == 4  # exact batch size, tail dropped
        assert a_h.shape[0] == 1 or np.unique(idx).size == 1  # one size
        shapes.add(canv.shape)
    assert len(shapes) == 1, shapes  # static across the epoch


def test_epoch_yields_despite_decode_failures_at_batch_size(tmp_path):
    """len(items) == batch_size with one corrupt image still yields a
    (smaller) batch: zero batches would mean fit() ran no steps."""
    rng = np.random.default_rng(0)
    captions = {}
    for i in range(8):
        fname = f"img_{i}.jpg"
        Image.fromarray(rng.integers(0, 256, (48, 48, 3), dtype=np.uint8)
                        ).save(tmp_path / fname, quality=92)
        captions[fname] = f"photo {i}"
    (tmp_path / "captions.json").write_text(json.dumps(captions))
    (tmp_path / "img_0.jpg").write_bytes(b"broken")
    ds = PairDataset(tmp_path, CLIPTokenizer(), TINY, batch_size=8, seed=0)
    batches = list(ds.epoch())
    assert len(batches) == 1
    assert batches[0][0].shape[0] == 7


def test_pair_dataset_yields_the_jax_packages_batches(tmp_path):
    """Same folder, seed and decode route: the same batches over two
    epochs (a mixed-size folder with one corrupt file): matrices, size
    indices and tokens equal; canvases equal but for the host resample's
    rounding, ``np.matmul`` in the port where the JAX package calls
    ``np.einsum`` (ROADMAP C): at most 1 in 8 bits on at most 0.1% of the
    values."""
    folder = _pair_folder(tmp_path)
    rng = np.random.default_rng(1)
    captions = json.loads((folder / "captions.json").read_text())
    for i in range(6):
        Image.fromarray(rng.integers(0, 256, (40 + 9 * i, 70 - 4 * i, 3), dtype=np.uint8)
                        ).save(folder / f"z{i}.jpg", quality=90)
        captions[f"z{i}.jpg"] = f"noise number {i}"
    (folder / "captions.json").write_text(json.dumps(captions))
    (folder / "img_003.jpg").write_bytes(b"broken")
    ds = PairDataset(folder, CLIPTokenizer(), TINY, batch_size=6, seed=3)
    ref = RefPairDataset(folder, RefTokenizer(), REF_TINY, batch_size=6, seed=3)
    assert len(ds) == len(ref) == 3
    for _ in range(2):
        got, want = list(ds.epoch()), list(ref.epoch())
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            diff = np.abs(g[0].astype(int) - np.asarray(w[0]).astype(int))
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
            for a, b in zip(g[1:], w[1:]):
                np.testing.assert_array_equal(a, np.asarray(b))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One epoch from one JAX init in each package, each into its own
    checkpoint directory."""
    root = tmp_path_factory.mktemp("train_runs")
    (root / "photos").mkdir()
    folder = _pair_folder(root / "photos")
    init = jax.device_get(init_params(jax.random.key(5), REF_TINY))
    _, want = ref_fit(
        REF_TINY, RefPairDataset(folder, RefTokenizer(), REF_TINY, batch_size=8, seed=4),
        epochs=1, learning_rate=1e-3, params=init, checkpoint_dir=root / "jax",
        log_every=100)
    _, got = fit(
        TINY, PairDataset(folder, CLIPTokenizer(), TINY, batch_size=8, seed=4),
        epochs=1, learning_rate=1e-3, params=params_from_numpy(init, TINY, "cpu"),
        checkpoint_dir=root / "port", log_every=100, device="cpu")
    return root, folder, {"jax": want, "port": got}


def test_clip_npz_crosses_packages(runs):
    """Each package's clip.npz loads leaf for leaf in the other, and the
    two one-epoch runs from one init agree."""
    root, _, histories = runs
    ref_tree, ref_spec = ref_load_params(root / "port" / "clip.npz")
    assert ref_spec == REF_TINY
    model, spec = load_model(root / "jax" / "clip.npz", device="cpu")
    assert spec == TINY
    jax_tree, _ = ref_load_params(root / "jax" / "clip.npz")
    for w, g in zip(jax.tree_util.tree_leaves(jax_tree), tree_leaves(params_to_numpy(model))):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert jax.tree_util.tree_structure(ref_tree) == jax.tree_util.tree_structure(jax_tree)
    # two Adam steps at lr 1e-3 from one init: an element whose gradient
    # is at rounding level may take another normalized step (up to lr;
    # seen: 0.22 lr on one of 3,162,112), so each leaf's RMS difference
    # is held to 1% of a step, and the losses to RESUME_RTOL
    for a, b in zip(jax.tree_util.tree_leaves(ref_tree), jax.tree_util.tree_leaves(jax_tree)):
        assert np.sqrt(np.mean((a - b) ** 2)) <= 0.01 * 1e-3
    np.testing.assert_allclose(histories["port"], histories["jax"], rtol=RESUME_RTOL)


def test_train_state_npz_has_the_jax_layout(runs):
    root, _, _ = runs
    with np.load(root / "jax" / "train_state.npz") as w, \
            np.load(root / "port" / "train_state.npz") as g:
        assert sorted(w.files) == sorted(g.files)
        for key in w.files:
            assert (g[key].shape, g[key].dtype) == (w[key].shape, w[key].dtype), key
        assert int(g["opt_0"]) == int(w["opt_0"]) == 2 and int(g["epoch"]) == 0
        n = (len(w.files) - 2) // 2
        for i in range(1, 2 * n + 1):  # mu then nu, leaf for leaf
            # two runs' moments: their gradients' rounding, compounded
            # over two steps; near-zero elements carry their leaf's
            want = w[f"opt_{i}"]
            np.testing.assert_allclose(g[f"opt_{i}"], want, rtol=1e-3,
                                       atol=1e-3 * np.abs(want).max())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_run_resumes_in_either_package(runs, tmp_path, writer):
    """One package's checkpoint directory, copied twice: the JAX package
    and the port each resume it for one epoch; the first resumed loss
    agrees, and both number the epoch after the saved one."""
    root, folder, _ = runs
    shutil.copytree(root / writer, tmp_path / "jax")
    shutil.copytree(root / writer, tmp_path / "port")
    _, want = ref_fit(REF_TINY, RefPairDataset(folder, RefTokenizer(), REF_TINY,
                                               batch_size=8, seed=6),
                      epochs=1, learning_rate=1e-3, checkpoint_dir=tmp_path / "jax",
                      resume=True, log_every=100)
    _, got = fit(TINY, PairDataset(folder, CLIPTokenizer(), TINY, batch_size=8, seed=6),
                 epochs=1, learning_rate=1e-3, checkpoint_dir=tmp_path / "port",
                 resume=True, log_every=100, device="cpu")
    np.testing.assert_allclose(got, want, rtol=RESUME_RTOL)
    for pkg in ("jax", "port"):
        with np.load(tmp_path / pkg / "train_state.npz") as data:
            assert int(data["epoch"]) == 1 and int(data["opt_0"]) == 4
