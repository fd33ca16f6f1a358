"""The port against tests/test_review3_fixes.py: regression tests for
the round-2 subsystem review findings
(models/preprocess/tokenizer/store/web sweep).

Harness only: engines are made on the CPU, and params come from the
port's ``init_params`` (a torch seed) through ``params_to_numpy``.
"""

import json

import numpy as np
import pytest
from PIL import Image

from evossearch_tpu_torch.core.constants import CLIPModelSpec

TINY = CLIPModelSpec(
    name="tiny", image_size=64, patch_size=16, vision_width=64,
    vision_layers=2, vision_heads=4, text_width=48, text_layers=2,
    text_heads=4, vocab_size=49408, context_length=77, embed_dim=32,
)


def test_infer_openai_spec_distinguishes_336px_variant():
    """A ViT-L/14@336px state dict matches ViT-L/14 on every field except
    image_size; without the image_size comparison it resolved to the
    224px spec and the 577-row pos_embed could never broadcast."""
    from evossearch_tpu_torch.models.convert import infer_openai_spec

    def l14_sd(grid):
        n_pos = grid * grid + 1
        sd = {
            "visual.conv1.weight": np.zeros((1024, 3, 14, 14), np.float32),
            "visual.positional_embedding": np.zeros((n_pos, 1024), np.float32),
            "text_projection": np.zeros((768, 768), np.float32),
            "ln_final.weight": np.zeros((768,), np.float32),
            "token_embedding.weight": np.zeros((49408, 768), np.float32),
            "positional_embedding": np.zeros((77, 768), np.float32),
        }
        for i in range(24):
            sd[f"visual.transformer.resblocks.{i}.x"] = np.zeros(1)
        for i in range(12):
            sd[f"transformer.resblocks.{i}.x"] = np.zeros(1)
        return sd

    spec224 = infer_openai_spec(l14_sd(grid=16))  # 224/14
    assert spec224.name == "ViT-L/14" and spec224.image_size == 224
    spec336 = infer_openai_spec(l14_sd(grid=24))  # 336/14
    assert spec336.image_size == 336, spec336
    assert spec336.name != "ViT-L/14"


def test_first_publish_race_with_concurrent_recovery(tmp_path, monkeypatch):
    """A concurrent reader's _recover_interrupted_swap can promote the
    staging dir between finalize()'s manifest write and its lock;
    finalize then displaces the promoted index to .old and must put it
    BACK instead of erroring with no live index."""
    import evossearch_tpu_torch.index.store as store_mod
    from evossearch_tpu_torch.index.store import IndexReader, IndexWriter

    folder = tmp_path / "photos"
    folder.mkdir()
    w = IndexWriter.create(folder, dim=8, model="tiny", dtype_name="float32")
    emb = np.eye(4, 8, dtype=np.float32)
    w.append(emb, [f"p{i}" for i in range(4)],
             [{"path": f"p{i}", "mtime": 1.0, "size": 2} for i in range(4)])

    import evossearch_tpu_torch.index.comments as comments_mod

    real_lock = comments_mod.comments_lock
    fired = {}

    def racing_lock(parent, name):
        # simulate the reader winning the race exactly once, right before
        # finalize acquires the lock (recovery's own nested lock use gets
        # the real lock because `fired` is already set)
        if not fired.get("x"):
            fired["x"] = True
            store_mod._recover_interrupted_swap(w.final_root)
        return real_lock(parent, name)

    monkeypatch.setattr(comments_mod, "comments_lock", racing_lock)
    w.finalize()  # must not raise

    reader = IndexReader.open(folder)
    assert reader is not None and reader.count == 4
    np.testing.assert_array_equal(np.asarray(reader.embeddings()), emb)
    assert not (folder / ".clip_index.tmp").exists()


def test_negative_content_length_reads_nothing():
    """Content-Length: -1 must not become read(-1) (read-to-EOF — the
    unbounded read the 413 cap exists to prevent)."""
    import io

    from evossearch_tpu_torch.server.web import Request

    class Exploding(io.RawIOBase):
        def read(self, n=-1):
            if n is None or n < 0:
                raise AssertionError("unbounded read(-1) issued")
            return b""

    env = {
        "REQUEST_METHOD": "POST",
        "PATH_INFO": "/x",
        "CONTENT_LENGTH": "-1",
        "wsgi.input": Exploding(),
    }
    req = Request(env)
    assert req.body == b""


def test_save_params_normalizes_suffix(tmp_path):
    from evossearch_tpu_torch.models import init_params, params_to_numpy
    from evossearch_tpu_torch.models.checkpoint import load_params, save_params

    params = params_to_numpy(init_params(TINY, seed=0, device="cpu"))
    written = save_params(tmp_path / "converted", params, TINY)
    assert written.name == "converted.npz" and written.exists()
    loaded, spec = load_params(written)
    assert spec.embed_dim == TINY.embed_dim


def test_init_params_independent_pos_embeds():
    """Visual and text positional embeddings must come from distinct PRNG
    streams (a shared key made text pos_embed a scaled copy of the
    visual one's leading values)."""
    from evossearch_tpu_torch.models import init_params, params_to_numpy

    params = params_to_numpy(init_params(TINY, seed=0, device="cpu"))
    v = np.asarray(params["visual"]["pos_embed"]).ravel()
    t = np.asarray(params["text"]["pos_embed"]).ravel()
    n = min(len(v), len(t))
    corr = np.corrcoef(v[:n] / np.std(v), t[:n] / np.std(t))[0, 1]
    assert abs(corr) < 0.2, corr
    tb = np.asarray(
        params["text"]["blocks"]["attn"]["wqkv"]
    ).ravel()[: len(t)]
    corr2 = np.corrcoef(t / np.std(t), tb / np.std(tb))[0, 1]
    assert abs(corr2) < 0.2, corr2


def test_encode_images_splits_heterogeneous_batches(tmp_path, monkeypatch):
    """A batch with more distinct sizes than MAX_UNIQUE_SIZES must split
    into bounded groups and produce the same embeddings as per-image
    encoding."""
    from evossearch_tpu_torch.core import Config
    from evossearch_tpu_torch.engine import SearchEngine
    from evossearch_tpu_torch.preprocess import pipeline

    monkeypatch.setenv("EVOSSEARCH_COMPUTE_DTYPE", "float32")
    monkeypatch.setattr(pipeline, "MAX_UNIQUE_SIZES", 3)
    eng = SearchEngine(cfg=Config(env_path=None), spec=TINY, device="cpu")
    rng = np.random.default_rng(0)
    arrays = [
        rng.integers(0, 256, (40 + 2 * i, 50 + 3 * i, 3), dtype=np.uint8)
        for i in range(8)  # 8 distinct sizes > cap of 3
    ]
    batched = eng.encode_images(arrays)
    singles = np.concatenate([eng.encode_images([a]) for a in arrays])
    assert batched.shape == (8, TINY.embed_dim)
    np.testing.assert_allclose(batched, singles, atol=2e-5)


def _make_folder(tmp_path, n=4):
    rng = np.random.default_rng(0)
    for i in range(n):
        Image.fromarray(
            rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)
        ).save(tmp_path / f"x{i}.jpg")
    return tmp_path


def test_open_index_does_not_block_behind_indexing_lock(tmp_path, monkeypatch):
    """/check_index and /search for a folder being indexed for the first
    time must answer 'not indexed' immediately, not block on the
    per-folder lock for the whole indexing run."""
    import threading

    from evossearch_tpu_torch.core import Config
    from evossearch_tpu_torch.engine import SearchEngine

    monkeypatch.setenv("EVOSSEARCH_COMPUTE_DTYPE", "float32")
    eng = SearchEngine(cfg=Config(env_path=None), spec=TINY, device="cpu")
    folder = str(_make_folder(tmp_path))
    lock = eng._folder_lock(folder)
    lock.acquire()  # simulate an in-flight first-time /index
    try:
        result = {}

        def probe():
            result["reader"] = eng.open_index(folder)

        t = threading.Thread(target=probe, daemon=True)
        t.start()
        t.join(timeout=5)
        assert not t.is_alive(), "open_index blocked on the indexing lock"
        assert result["reader"] is None
    finally:
        lock.release()


def test_cache_stamped_with_preopen_mtime(tmp_path, monkeypatch):
    """_cached_index must key the entry by the mtime statted BEFORE open:
    a re-index finalizing in between must cause a re-open on the next
    query, not serve the old reader forever."""
    from evossearch_tpu_torch.core import Config
    from evossearch_tpu_torch.engine import SearchEngine, _canon

    monkeypatch.setenv("EVOSSEARCH_COMPUTE_DTYPE", "float32")
    eng = SearchEngine(cfg=Config(env_path=None), spec=TINY, device="cpu")
    folder = str(_make_folder(tmp_path))
    assert eng.index_folder(folder) == 4
    entry, reader = eng._cached_index(folder)
    stamped = entry["mtime"]
    # simulate a re-index bumping the manifest AFTER the entry was built
    manifest = tmp_path / ".clip_index" / "manifest.json"
    import os
    os.utime(manifest, (manifest.stat().st_mtime + 10,) * 2)
    entry2, reader2 = eng._cached_index(folder)
    assert entry2 is not entry, "stale entry served after manifest change"


def test_serve_image_for_relatively_indexed_folder(tmp_path, monkeypatch):
    """Indexes built from a relative folder path store relative paths;
    /image/ requests arrive absolute and must still be served."""
    from evossearch_tpu_torch.core import Config
    from evossearch_tpu_torch.engine import SearchEngine
    from evossearch_tpu_torch.server import TestClient, create_app

    monkeypatch.setenv("EVOSSEARCH_COMPUTE_DTYPE", "float32")
    _make_folder(tmp_path / "photos" if False else tmp_path)
    monkeypatch.chdir(tmp_path.parent)
    rel = tmp_path.name
    eng = SearchEngine(cfg=Config(env_path=None), spec=TINY, device="cpu")
    assert eng.index_folder(rel) == 4
    client = TestClient(create_app(engine=eng, cfg=eng.cfg))
    abs_target = str(tmp_path / "x1.jpg")
    r = client.get("/image/" + abs_target)
    assert r.status_code == 200, r.status_code


def test_failed_encode_does_not_leak_producer_thread(tmp_path, monkeypatch):
    """A consumer-side failure mid-build must unblock and terminate the
    producer thread instead of leaking it on the bounded queue."""
    import threading

    from evossearch_tpu_torch.core import Config
    from evossearch_tpu_torch.engine import SearchEngine

    monkeypatch.setenv("EVOSSEARCH_COMPUTE_DTYPE", "float32")
    # pipeline batch 2 BEFORE Config snapshots the env: 8 images / batch 2
    # means the producer has batches queued behind the bounded queue when
    # the consumer dies — the scenario the drain logic exists for
    monkeypatch.setenv("EVOSSEARCH_INDEX_BATCH", "2")
    eng = SearchEngine(cfg=Config(env_path=None), spec=TINY, device="cpu")
    assert eng._index_batch == 2
    folder = str(_make_folder(tmp_path, n=8))

    def boom(*a, **k):
        raise RuntimeError("device on fire")

    # both batch kinds must die: jpg fixtures ride the planar path
    monkeypatch.setattr(eng, "encode_prepared", boom)
    monkeypatch.setattr(eng, "encode_prepared_planar", boom)
    with pytest.raises(RuntimeError):
        eng.index_folder(folder)
    import time
    deadline = time.time() + 5
    while time.time() < deadline:
        if not any(
            t.name == "index-producer" and t.is_alive()
            for t in threading.enumerate()
        ):
            break
        time.sleep(0.05)
    leaked = [t.name for t in threading.enumerate()
              if t.name == "index-producer" and t.is_alive()]
    assert not leaked, leaked
