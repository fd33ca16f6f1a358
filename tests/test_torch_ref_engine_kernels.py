"""The port's search-kernel selection: tests/test_engine_kernels.py held
against evossearch_tpu_torch. Every configured kernel returns the same
exact result set (xla / pallas / host / sharded), IVF approximates it, and
checkpoint save/load round-trips.

The JAX file runs on the conftest's 8 forced XLA host devices; here
``parallel.mesh.available_devices`` is monkeypatched to return the
engine's device 8 times for every test (the ``eight`` fixture, as in
tests/test_torch_engine_sharded.py), so ``auto`` resolves to ``sharded``
and IVF under ``sharded`` writes ``ivf_mesh8.npz``. Every test runs on the
CPU and, marked ``gpu``, on the card (the ``device`` fixture; the card
case skips in its body without one). ``test_checkpoint_roundtrip`` makes
its params with the port's ``init_params`` (a torch generator, not a JAX
PRNG key) and saves them through ``params_to_numpy``.

Added beside the JAX file's tests: ``test_pallas_kernel_reaches_block``
drives ``SEARCH_KERNEL=pallas`` over a 512-row store at d = 128, the
smallest the candidate kernels take (``index/search.py:pallas_search_batch``),
and on the card asserts that the block kernel was launched.

Imports neither JAX nor the JAX package, so it also collects on a GPU
machine without them."""

import numpy as np
import pytest
import torch
from PIL import Image

from evossearch_tpu_torch.core import Config
from evossearch_tpu_torch.core.constants import CLIPModelSpec
from evossearch_tpu_torch.engine import SearchEngine
from evossearch_tpu_torch.parallel import mesh

TINY = CLIPModelSpec(
    name="tiny", image_size=64, patch_size=16, vision_width=64,
    vision_layers=2, vision_heads=4, text_width=48, text_layers=2,
    text_heads=4, vocab_size=49408, context_length=77, embed_dim=32,
)
# the narrowest width the candidate kernels take (d % 128 == 0)
WIDE = CLIPModelSpec(**{**TINY.__dict__, "name": "tiny128", "embed_dim": 128})


@pytest.fixture(scope="module",
                params=["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return request.param


@pytest.fixture(autouse=True)
def eight(monkeypatch):
    """Eight devices for every engine of the test (the conftest's forced
    XLA host devices in the JAX file)."""
    monkeypatch.setattr(mesh, "available_devices",
                        lambda device: [torch.device(device)] * 8)


@pytest.fixture(scope="module")
def indexed_folder(tmp_path_factory, device):
    import os

    folder = tmp_path_factory.mktemp(f"kimgs_{device}")
    rng = np.random.default_rng(0)
    for i in range(10):
        arr = rng.integers(0, 256, (60, 80, 3), dtype=np.uint8)
        Image.fromarray(arr).save(folder / f"img_{i}.jpg", quality=90)
    os.environ["EVOSSEARCH_COMPUTE_DTYPE"] = "float32"
    eng = SearchEngine(cfg=Config(env_path=None), spec=TINY, device=device)
    assert eng.index_folder(str(folder)) == 10
    return folder


def _engine(monkeypatch, device, kernel=None, index_kind=None, spec=TINY):
    monkeypatch.setenv("EVOSSEARCH_COMPUTE_DTYPE", "float32")
    if kernel:
        monkeypatch.setenv("EVOSSEARCH_SEARCH_KERNEL", kernel)
    if index_kind:
        monkeypatch.setenv("EVOSSEARCH_INDEX_KIND", index_kind)
    return SearchEngine(cfg=Config(env_path=None), spec=spec, device=device)


@pytest.mark.parametrize("kernel", ["xla", "pallas", "host", "sharded"])
def test_all_kernels_agree(indexed_folder, monkeypatch, kernel, device):
    base = _engine(monkeypatch, device, "xla")
    q = base.encode_text("reference query")
    s0, i0, _ = base.search_embedding(str(indexed_folder), q, 5)
    eng = _engine(monkeypatch, device, kernel)
    s1, i1, _ = eng.search_embedding(str(indexed_folder), q, 5)
    np.testing.assert_array_equal(i1, i0)
    np.testing.assert_allclose(s1, s0, atol=1e-5)


def test_auto_kernel_resolves(indexed_folder, monkeypatch, device):
    eng = _engine(monkeypatch, device)  # auto; 8 devices -> sharded
    assert eng._resolve_kernel() == "sharded"
    q = eng.encode_text("x")
    s, i, _ = eng.search_embedding(str(indexed_folder), q, 3)
    assert len(s) == 3


def test_ivf_index_kind(indexed_folder, monkeypatch, device):
    eng = _engine(monkeypatch, device, index_kind="ivf")
    q = eng.encode_text("x")
    res = eng.search_embedding(str(indexed_folder), q, 10)
    assert res is not None
    s, i, reader = res
    assert len(s) == 10 and len(set(i.tolist())) == 10


def test_ivf_sharded_kernel(indexed_folder, monkeypatch, device):
    """INDEX_KIND=ivf + SEARCH_KERNEL=sharded serves the mesh-sharded IVF
    (per-shard buckets, a merge of the blocks), persists its
    mesh-size-specific sidecar, and a fresh engine reloads it without
    rebuilding."""
    eng = _engine(monkeypatch, device, kernel="sharded", index_kind="ivf")
    q = eng.encode_text("x")
    s, i, reader = eng.search_embedding(str(indexed_folder), q, 10)
    assert len(s) == 10 and len(set(i.tolist())) == 10
    entry, _ = eng._cached_index(str(indexed_folder))
    from evossearch_tpu_torch.parallel import ShardedIVFIndex

    assert isinstance(entry.get("sharded_ivf"), ShardedIVFIndex)
    assert (reader.root / "ivf_mesh8.npz").exists()

    # agreement with the exact sharded kernel on the same store
    exact = _engine(monkeypatch, device, kernel="sharded")
    es, ei, _ = exact.search_embedding(str(indexed_folder), q, 10)
    assert set(i.tolist()) == set(ei.tolist())  # 10-row corpus: full recall

    # a fresh engine must LOAD the sidecar, never rebuild
    eng2 = _engine(monkeypatch, device, kernel="sharded", index_kind="ivf")
    monkeypatch.setattr(
        ShardedIVFIndex, "build",
        classmethod(lambda *a, **k: pytest.fail("rebuilt despite sidecar")),
    )
    s2, i2, _ = eng2.search_embedding(str(indexed_folder), q, 10)
    np.testing.assert_array_equal(i2, i)
    eng.close()
    eng2.close()
    exact.close()


def test_checkpoint_roundtrip(tmp_path, device):
    from evossearch_tpu_torch.models import init_params, load_model
    from evossearch_tpu_torch.models.checkpoint import (
        load_params, params_to_numpy, save_params, tree_leaves,
    )

    model = init_params(TINY, seed=0, device=device)
    params = params_to_numpy(model)
    save_params(tmp_path / "ckpt.npz", params, TINY)
    loaded, spec = load_params(tmp_path / "ckpt.npz")
    assert spec == TINY
    for a, b in zip(tree_leaves(params), tree_leaves(loaded)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # and back onto the device as a module
    again, spec = load_model(tmp_path / "ckpt.npz", device)
    assert spec == TINY
    for (name, a), (_, b) in zip(model.state_dict().items(),
                                 again.state_dict().items()):
        assert torch.equal(a, b), name


def test_pallas_kernel_reaches_block(tmp_path, monkeypatch, device):
    """SEARCH_KERNEL=pallas over a 512-row store at d = 128: the engine
    reaches the block kernel (launched on the card, its plain version on
    the CPU) and answers the exact top-k, ties by lower row."""
    from evossearch_tpu_torch.index.store import IndexWriter
    from evossearch_tpu_torch.ops import topk

    n, d = 512, WIDE.embed_dim
    rng = np.random.default_rng(7)
    emb = rng.standard_normal((n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    folder = tmp_path / "wide"
    folder.mkdir()
    w = IndexWriter.create(folder, model="tiny128", dim=d, dtype_name="float32")
    paths = [str(folder / f"img_{i:04d}.jpg") for i in range(n)]
    w.append(emb, paths, [{"path": p, "mtime": 1.0, "size": 10} for p in paths])
    w.finalize()
    monkeypatch.setenv("EVOSSEARCH_MICROBATCH_MS", "0")
    eng = _engine(monkeypatch, device, kernel="pallas", spec=WIDE)
    q = rng.standard_normal(d).astype(np.float32)
    q /= np.linalg.norm(q)
    before = dict(topk.DTYPE_LAUNCHES)
    s, i, _ = eng.search_embedding(str(folder), q, 12)
    np.testing.assert_array_equal(i, np.argsort(-(emb @ q), kind="stable")[:12])
    np.testing.assert_allclose(s, np.sort(emb @ q)[::-1][:12], rtol=0, atol=1e-5)
    launched = topk.DTYPE_LAUNCHES["block_f32"] - before["block_f32"]
    assert launched == (1 if device == "cuda" else 0)
    eng.close()
