"""The port against tests/test_concurrency.py: race-safety tests
(SURVEY.md §5: the reference has unlocked JSON read-modify-write at
oldapp.py:152-165 — last-writer-wins loses comments). Our comment store
appends under an fcntl lock; no comment may be lost.

Harness only: the engines are made on the CPU.
"""

import threading

from evossearch_tpu_torch.index import add_image_comment, get_image_comments


def test_concurrent_comment_appends_lose_nothing(tmp_path):
    n_threads, per_thread = 8, 5
    errors = []

    def worker(tid):
        try:
            for j in range(per_thread):
                assert add_image_comment(
                    tmp_path, "/img/x.jpg", f"t{tid}-c{j}"
                )
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    comments = get_image_comments(tmp_path, "/img/x.jpg")
    assert len(comments) == n_threads * per_thread
    bodies = {c.split("] ", 1)[1] for c in comments}
    assert len(bodies) == n_threads * per_thread  # every append survived


def test_concurrent_index_requests_serialized(tmp_path, monkeypatch):
    """Two simultaneous /index runs on the same folder must not corrupt the
    staging dir; both complete and the final index is valid."""
    import numpy as np
    from PIL import Image

    from evossearch_tpu_torch.core import Config
    from evossearch_tpu_torch.core.constants import CLIPModelSpec
    from evossearch_tpu_torch.engine import SearchEngine

    tiny = CLIPModelSpec(
        name="tiny", image_size=64, patch_size=16, vision_width=64,
        vision_layers=2, vision_heads=4, text_width=48, text_layers=2,
        text_heads=4, vocab_size=49408, context_length=77, embed_dim=32,
    )
    rng = np.random.default_rng(0)
    for i in range(4):
        Image.fromarray(
            rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)
        ).save(tmp_path / f"c{i}.jpg")
    monkeypatch.setenv("EVOSSEARCH_COMPUTE_DTYPE", "float32")
    eng = SearchEngine(cfg=Config(env_path=None), spec=tiny, device="cpu")
    results = []
    threads = [
        threading.Thread(
            target=lambda: results.append(eng.index_folder(str(tmp_path)))
        )
        for _ in range(3)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert results == [4, 4, 4]
    assert eng.is_indexed(str(tmp_path))


def test_index_cache_lru_bounded(tmp_path, monkeypatch):
    import numpy as np
    from PIL import Image

    from evossearch_tpu_torch.core import Config
    from evossearch_tpu_torch.core.constants import CLIPModelSpec
    from evossearch_tpu_torch.engine import SearchEngine

    tiny = CLIPModelSpec(
        name="tiny", image_size=64, patch_size=16, vision_width=64,
        vision_layers=2, vision_heads=4, text_width=48, text_layers=2,
        text_heads=4, vocab_size=49408, context_length=77, embed_dim=32,
    )
    monkeypatch.setenv("EVOSSEARCH_COMPUTE_DTYPE", "float32")
    eng = SearchEngine(cfg=Config(env_path=None), spec=tiny, device="cpu")
    eng._max_cached_folders = 2
    rng = np.random.default_rng(1)
    q = None
    for j in range(4):
        folder = tmp_path / f"f{j}"
        folder.mkdir()
        for i in range(2):
            Image.fromarray(
                rng.integers(0, 256, (30, 30, 3), dtype=np.uint8)
            ).save(folder / f"i{i}.jpg")
        eng.index_folder(str(folder))
        q = q if q is not None else eng.encode_text("x")
        assert eng.search_embedding(str(folder), q, 2) is not None
    assert len(eng._index_cache) <= 2
    # evicted folders still searchable (cache refill, not an error)
    assert eng.search_embedding(str(tmp_path / "f0"), q, 2) is not None


def test_search_during_reindex_atomicity(tmp_path):
    """Readers must always see either the old or the new index, never a
    torn one (atomic two-rename publish)."""
    import numpy as np

    from evossearch_tpu_torch.index import IndexReader, IndexWriter

    def write(n):
        w = IndexWriter.create(tmp_path, model="m", dim=4, rows_per_shard=64)
        emb = np.full((n, 4), float(n), np.float32)
        w.append(emb, [f"/i/{j}.jpg" for j in range(n)],
                 [{"path": str(j)} for j in range(n)])
        w.finalize()

    write(5)
    stop = threading.Event()
    bad = []

    def reader_loop():
        while not stop.is_set():
            r = IndexReader.open(tmp_path)
            if r is None:
                continue  # transiently mid-swap: treated as not-indexed, OK
            if r.count not in (5, 9):
                bad.append(r.count)
            arr = np.asarray(r.embeddings())
            if arr.shape[0] != r.count or len({float(v) for v in arr[:, 0]}) > 1:
                bad.append("torn")

    t = threading.Thread(target=reader_loop)
    t.start()
    for _ in range(10):
        write(9)
        write(5)
    stop.set()
    t.join()
    assert not bad, bad
