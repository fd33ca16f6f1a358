"""The port against tests/test_ivf_persistence.py: iVF persistence:
save/load round-trip and engine reuse across restarts.

Harness only: the engines, IVF builds and loads are made on the CPU.
"""

import numpy as np
import pytest
from PIL import Image

from evossearch_tpu_torch.core import Config
from evossearch_tpu_torch.core.constants import CLIPModelSpec
from evossearch_tpu_torch.engine import SearchEngine
from evossearch_tpu_torch.index.ivf import IVFIndex
from evossearch_tpu_torch.index.search import exact_search_host_reader

TINY = CLIPModelSpec(
    name="tiny", image_size=64, patch_size=16, vision_width=64,
    vision_layers=2, vision_heads=4, text_width=48, text_layers=2,
    text_heads=4, vocab_size=49408, context_length=77, embed_dim=32,
)


def test_ivf_save_load_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((500, 32)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    ivf = IVFIndex.build(emb, nlist=8, iters=3, device="cpu")
    q = emb[42]
    s1, i1 = ivf.search(q, 10, nprobe=8)
    ivf.save(tmp_path / "ivf.npz")
    loaded = IVFIndex.load(tmp_path / "ivf.npz", device="cpu")
    assert loaded is not None and loaded.n == 500 and loaded.nlist == 8
    s2, i2 = loaded.search(q, 10, nprobe=8)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(s1, s2, atol=1e-6)


def test_ivf_load_corrupt_returns_none(tmp_path):
    (tmp_path / "ivf.npz").write_bytes(b"garbage")
    assert IVFIndex.load(tmp_path / "ivf.npz", device="cpu") is None


def test_engine_persists_and_reuses_ivf(tmp_path, monkeypatch):
    rng = np.random.default_rng(1)
    for i in range(8):
        Image.fromarray(
            rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)
        ).save(tmp_path / f"i{i}.jpg")
    monkeypatch.setenv("EVOSSEARCH_COMPUTE_DTYPE", "float32")
    monkeypatch.setenv("EVOSSEARCH_INDEX_KIND", "ivf")
    # Pin the single-device kernel: under the forced 8-device test mesh
    # "auto" resolves to "sharded", which routes INDEX_KIND=ivf to the
    # mesh-sharded IVF and its own sidecar (ivf_mesh8.npz — covered by
    # test_engine_kernels). This test pins the SINGLE-DEVICE sidecar.
    monkeypatch.setenv("EVOSSEARCH_SEARCH_KERNEL", "best")
    eng = SearchEngine(cfg=Config(env_path=None), spec=TINY, device="cpu")
    assert eng.index_folder(str(tmp_path)) == 8
    q = eng.encode_text("x")
    s1, i1, reader = eng.search_embedding(str(tmp_path), q, 5)
    assert (reader.root / "ivf.npz").exists()

    # fresh engine ("server restart"): must load, not retrain
    import evossearch_tpu_torch.index.ivf as ivf_mod

    def boom(*a, **kw):  # pragma: no cover
        raise AssertionError("IVF retrained despite persisted file")

    eng2 = SearchEngine(cfg=Config(env_path=None), spec=TINY, device="cpu")
    monkeypatch.setattr(ivf_mod.IVFIndex, "build", classmethod(boom))
    s2, i2, _ = eng2.search_embedding(str(tmp_path), q, 5)
    np.testing.assert_array_equal(i1, i2)


def test_host_reader_search_multi_shard(tmp_path):
    from evossearch_tpu_torch.index import IndexReader, IndexWriter

    rng = np.random.default_rng(2)
    emb = rng.standard_normal((50, 16)).astype(np.float32)
    w = IndexWriter.create(tmp_path, model="m", dim=16, rows_per_shard=16)
    w.append(emb, [f"/p/{i}" for i in range(50)],
             [{"path": str(i)} for i in range(50)])
    w.finalize()
    reader = IndexReader.open(tmp_path)
    assert len(reader.shard_arrays()) == 4
    q = rng.standard_normal(16).astype(np.float32)
    s, i = exact_search_host_reader(reader, q, 12)
    scores = emb @ q
    oracle = np.lexsort((np.arange(50), -scores))[:12]
    np.testing.assert_array_equal(i, oracle)
