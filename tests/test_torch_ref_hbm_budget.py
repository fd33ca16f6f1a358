"""The port's device-budget routing and cache eviction:
tests/test_hbm_budget.py held against evossearch_tpu_torch (VERDICT r2
weak #1).

Two synthetic folders whose corpora exceed a shrunken device budget must
both answer exactly (via the host mmap scanner) without ever materializing
a device matrix; two folders that fit individually but not together must
evict each other LRU-first instead of accumulating.

Every test runs on the CPU and, marked ``gpu``, on the card (the
``device`` fixture), where ``HBM_BUDGET_MB=0`` reads the budget from the
card's own memory. Harness only: engines and IVF builds are given their
device; ``test_failed_materialization_rolls_back_reservation`` fails the
port's own read of the store (``reader.shard_arrays``, which
``engine._to_device`` copies from) where the JAX file fails
``reader.embeddings``, and the reservation rolls back as in the JAX
package. Imports neither JAX nor the JAX package.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from evossearch_tpu_torch.core import Config
from evossearch_tpu_torch.core.constants import CLIPModelSpec
from evossearch_tpu_torch.engine import SearchEngine, _canon
from evossearch_tpu_torch.index.store import IndexWriter

TINY = CLIPModelSpec(
    name="tiny", image_size=64, patch_size=16, vision_width=64,
    vision_layers=2, vision_heads=4, text_width=48, text_layers=2,
    text_heads=4, vocab_size=49408, context_length=77, embed_dim=256,
)

D = 256


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return request.param


def _make_index(folder, n, seed):
    folder = Path(folder)
    folder.mkdir(exist_ok=True)
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((n, D)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    w = IndexWriter.create(folder, model="tiny", dim=D, dtype_name="float32")
    paths = [str(folder / f"img_{i:05d}.jpg") for i in range(n)]
    meta = [{"path": p, "mtime": 1.0, "size": 10} for p in paths]
    w.append(emb, paths, meta)
    w.finalize()
    return emb


def _oracle(emb, q, k):
    scores = emb @ q
    order = np.lexsort((np.arange(len(scores)), -scores))[:k]
    return scores[order], order


def _engine(monkeypatch, tmp_path, budget_mb, device, microbatch="0"):
    for k in ("EVOSSEARCH_CHECKPOINT", "EVOSSEARCH_BPE_VOCAB"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("EVOSSEARCH_HBM_BUDGET_MB", str(budget_mb))
    monkeypatch.setenv("EVOSSEARCH_SEARCH_KERNEL", "xla")
    monkeypatch.setenv("EVOSSEARCH_MICROBATCH_MS", microbatch)
    # These tests pin the HOST route's behavior; the SQ8 device tier has
    # its own routing suite (tests/test_sq8.py).
    monkeypatch.setenv("EVOSSEARCH_SQ8", "off")
    return SearchEngine(cfg=Config(env_path=tmp_path / "missing.env"), spec=TINY,
                        device=device)


def test_over_budget_corpora_route_to_host_scanner(monkeypatch, tmp_path, device):
    # two 2 MB f32 corpora vs a 1 MB budget: neither may ever device-put
    eng = _engine(monkeypatch, tmp_path, budget_mb=1, device=device)
    assert eng._hbm_budget == 1 << 20
    embs = {}
    for name, seed in (("a", 0), ("b", 1)):
        folder = tmp_path / name
        embs[name] = _make_index(folder, 2000, seed)
    rng = np.random.default_rng(7)
    q = rng.standard_normal(D).astype(np.float32)
    for name in ("a", "b"):
        folder = str(tmp_path / name)
        s, i, reader = eng.search_embedding(folder, q, 10)
        es, ei = _oracle(embs[name], q, 10)
        np.testing.assert_array_equal(i, ei)
        np.testing.assert_allclose(s, es, rtol=1e-5)
        entry = eng._index_cache[_canon(folder)]
        assert "emb" not in entry and "sharded" not in entry
        assert entry["fits_device"] is False
    assert eng.counters.snapshot()["host_routed_queries"] == 2


def test_over_budget_batcher_path_routes_to_host(monkeypatch, tmp_path, device):
    eng = _engine(monkeypatch, tmp_path, budget_mb=1, device=device, microbatch="2")
    try:
        emb = _make_index(tmp_path / "a", 2000, 3)
        q = np.random.default_rng(9).standard_normal(D).astype(np.float32)
        s, i, _ = eng.search_embedding(str(tmp_path / "a"), q, 5)
        es, ei = _oracle(emb, q, 5)
        np.testing.assert_array_equal(i, ei)
        assert "emb" not in eng._index_cache[_canon(str(tmp_path / "a"))]
    finally:
        eng.close()


def test_fitting_corpora_evict_lru_device_state(monkeypatch, tmp_path, device):
    # each corpus ~0.7 MB; budget 1 MB: both fit alone, not together
    eng = _engine(monkeypatch, tmp_path, budget_mb=1, device=device)
    embs = {}
    for name, seed in (("a", 4), ("b", 5)):
        embs[name] = _make_index(tmp_path / name, 700, seed)
    q = np.random.default_rng(11).standard_normal(D).astype(np.float32)

    s, i, _ = eng.search_embedding(str(tmp_path / "a"), q, 5)
    np.testing.assert_array_equal(i, _oracle(embs["a"], q, 5)[1])
    entry_a = eng._index_cache[_canon(str(tmp_path / "a"))]
    assert "emb" in entry_a and entry_a["device_bytes"] == 700 * D * 4

    s, i, _ = eng.search_embedding(str(tmp_path / "b"), q, 5)
    np.testing.assert_array_equal(i, _oracle(embs["b"], q, 5)[1])
    entry_b = eng._index_cache[_canon(str(tmp_path / "b"))]
    assert "emb" in entry_b
    # a's device matrix was evicted; its reader/metadata stay cached
    assert "emb" not in entry_a and entry_a["device_bytes"] == 0
    assert eng.counters.snapshot()["hbm_evictions"] == 1

    # querying a again re-materializes (evicting b) and still answers exactly
    s, i, _ = eng.search_embedding(str(tmp_path / "a"), q, 5)
    np.testing.assert_array_equal(i, _oracle(embs["a"], q, 5)[1])
    assert "emb" in entry_a and "emb" not in entry_b


def test_over_budget_ivf_serves_host_probe(monkeypatch, tmp_path, device):
    """INDEX_KIND=ivf + over-budget corpus + matching sidecar: queries go
    through the host IVF probe (zero device bytes), not the exact scan.
    Full-nprobe probes cover every row, so results equal the oracle."""
    from evossearch_tpu_torch.index.ivf import IVFIndex

    folder = tmp_path / "a"
    emb = _make_index(folder, 2000, seed=21)
    IVFIndex.build(emb, nlist=16, iters=3, device="cpu").save(
        folder / ".clip_index" / "ivf.npz"
    )
    monkeypatch.setenv("EVOSSEARCH_INDEX_KIND", "ivf")
    monkeypatch.setenv("EVOSSEARCH_IVF_NLIST", "16")
    monkeypatch.setenv("EVOSSEARCH_IVF_NPROBE", "16")
    eng = _engine(monkeypatch, tmp_path, budget_mb=1, device=device)
    q = np.random.default_rng(23).standard_normal(D).astype(np.float32)
    s, i, _ = eng.search_embedding(str(folder), q, 10)
    es, ei = _oracle(emb, q, 10)
    np.testing.assert_array_equal(i, ei)
    np.testing.assert_allclose(s, es, rtol=1e-5)
    entry = eng._index_cache[_canon(str(folder))]
    assert "emb" not in entry and "ivf" not in entry  # no device state
    assert isinstance(entry["ivf_host"].centroids, np.ndarray)
    assert eng.counters.snapshot()["ivf_host_queries"] == 1

    # batched route (batcher submissions land here) pads short rows
    s2, i2 = eng._execute_search_batch(str(folder), q[None], 10)
    np.testing.assert_array_equal(i2[0], ei)


def test_over_budget_ivf_without_sidecar_falls_back_to_exact(
    monkeypatch, tmp_path, device
):
    folder = tmp_path / "a"
    emb = _make_index(folder, 2000, seed=31)
    monkeypatch.setenv("EVOSSEARCH_INDEX_KIND", "ivf")
    eng = _engine(monkeypatch, tmp_path, budget_mb=1, device=device)
    q = np.random.default_rng(33).standard_normal(D).astype(np.float32)
    s, i, _ = eng.search_embedding(str(folder), q, 10)
    np.testing.assert_array_equal(i, _oracle(emb, q, 10)[1])
    snap = eng.counters.snapshot()
    assert snap["host_routed_queries"] == 1
    assert "ivf_host_queries" not in snap
    assert eng._index_cache[_canon(str(folder))]["ivf_host"] is None


def test_over_budget_ivf_batcher_path(monkeypatch, tmp_path, device):
    from evossearch_tpu_torch.index.ivf import IVFIndex

    folder = tmp_path / "a"
    emb = _make_index(folder, 2000, seed=41)
    IVFIndex.build(emb, nlist=16, iters=3, device="cpu").save(
        folder / ".clip_index" / "ivf.npz"
    )
    monkeypatch.setenv("EVOSSEARCH_INDEX_KIND", "ivf")
    monkeypatch.setenv("EVOSSEARCH_IVF_NLIST", "16")
    monkeypatch.setenv("EVOSSEARCH_IVF_NPROBE", "16")
    eng = _engine(monkeypatch, tmp_path, budget_mb=1, device=device, microbatch="2")
    try:
        q = np.random.default_rng(43).standard_normal(D).astype(np.float32)
        s, i, _ = eng.search_embedding(str(folder), q, 10)
        np.testing.assert_array_equal(i, _oracle(emb, q, 10)[1])
        assert "emb" not in eng._index_cache[_canon(str(folder))]
    finally:
        eng.close()


def test_failed_materialization_rolls_back_reservation(monkeypatch, tmp_path, device):
    """A materialization that throws (transient device OOM / relay error)
    must not leave phantom device_bytes behind: they'd be charged again on
    retry and permanently inflate the cached total, evicting every other
    folder on every materialization until restart."""
    eng = _engine(monkeypatch, tmp_path, budget_mb=100, device=device)
    emb = _make_index(tmp_path / "a", 500, seed=51)
    entry, reader = eng._cached_index(str(tmp_path / "a"))
    orig = reader.shard_arrays

    def boom():
        raise RuntimeError("transient device error")

    monkeypatch.setattr(reader, "shard_arrays", boom)
    with pytest.raises(RuntimeError):
        eng._entry_emb(entry, reader)
    assert entry.get("device_bytes", 0) == 0 and "emb" not in entry

    monkeypatch.setattr(reader, "shard_arrays", orig)
    out = eng._entry_emb(entry, reader)
    assert out.shape == (500, D)
    assert entry["device_bytes"] == 500 * D * 4  # charged exactly once


def test_reservation_precedes_device_put(monkeypatch, tmp_path, device):
    """Eviction must run BEFORE the new corpus lands on device for every
    materialization path — reserve-after-put lets old+new coexist
    transiently and OOM the chip at the flagship scale."""
    from evossearch_tpu_torch.index.ivf import IVFIndex
    from evossearch_tpu_torch.parallel import ShardedIndex

    folder = tmp_path / "a"
    emb = _make_index(folder, 400, seed=61)
    IVFIndex.build(emb, nlist=8, iters=2, device="cpu").save(
        folder / ".clip_index" / "ivf.npz"
    )

    eng = _engine(monkeypatch, tmp_path, budget_mb=100, device=device)
    entry, reader = eng._cached_index(str(folder))

    seen = {}
    orig_fr = ShardedIndex.from_reader.__func__

    def spy_from_reader(cls, reader_, mesh=None, n_devices=0):
        seen["sharded_reserved"] = entry.get("device_bytes", 0) > 0
        return orig_fr(cls, reader_, mesh=mesh, n_devices=n_devices)

    monkeypatch.setattr(
        ShardedIndex, "from_reader", classmethod(spy_from_reader)
    )
    eng._entry_sharded(entry, reader)
    assert seen["sharded_reserved"] is True

    orig_load = IVFIndex.load.__func__

    def spy_load(cls, path, host=False, device=None):
        seen["ivf_reserved"] = entry.get("device_bytes", 0) > 0
        return orig_load(cls, path, host=host, device=device)

    monkeypatch.setattr(IVFIndex, "load", classmethod(spy_load))
    monkeypatch.setenv("EVOSSEARCH_IVF_NLIST", "8")
    eng.cfg.IVF_NLIST = 8
    entry.pop("device_bytes", None)
    eng._entry_ivf(entry, reader)
    assert seen["ivf_reserved"] is True


def test_concurrent_readers_survive_eviction(monkeypatch, tmp_path, device):
    """Readers take a local ref via .get(): eviction popping 'emb' from a
    live entry between another thread's membership check and its read
    must never KeyError (the pre-fix double-checked pattern did)."""
    import threading

    eng = _engine(monkeypatch, tmp_path, budget_mb=1, device=device)
    embs = {}
    for name, seed in (("a", 71), ("b", 72)):
        embs[name] = _make_index(tmp_path / name, 700, seed)
    entry_a, reader_a = eng._cached_index(str(tmp_path / "a"))
    entry_b, reader_b = eng._cached_index(str(tmp_path / "b"))

    errors = []
    stop = threading.Event()

    def reader_loop():
        while not stop.is_set():
            try:
                emb = eng._entry_emb(entry_a, reader_a)
                assert emb.shape == (700, D)
            except Exception as e:  # pragma: no cover - the regression
                errors.append(e)
                return

    threads = [threading.Thread(target=reader_loop) for _ in range(4)]
    for t in threads:
        t.start()
    try:
        for _ in range(60):  # each b-materialization evicts a, and back
            eng._entry_emb(entry_b, reader_b)
            eng._entry_emb(entry_a, reader_a)
            with eng._cache_lock:
                entry_b.pop("emb", None)
                entry_b["device_bytes"] = 0
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
    assert not errors, errors


def test_host_scan_does_not_block_device_folder_queries(
    monkeypatch, tmp_path, device
):
    """A seconds-long over-budget host scan must not head-of-line block
    device-resident folders' searches: they ride separate batcher
    workers."""
    import threading
    import time as _time

    from evossearch_tpu_torch.index import search as search_mod

    eng = _engine(monkeypatch, tmp_path, budget_mb=1, device=device, microbatch="2")
    try:
        # big = over budget (2000 rows > 1 MB), small = fits (700 rows)
        big = _make_index(tmp_path / "big", 2000, seed=81)
        small = _make_index(tmp_path / "small", 700, seed=82)
        q = np.random.default_rng(83).standard_normal(D).astype(np.float32)

        orig = search_mod.exact_search_host_reader_batch
        entered = threading.Event()

        def slow_scan(reader, queries, k):
            entered.set()
            _time.sleep(1.0)
            return orig(reader, queries, k)

        monkeypatch.setattr(
            search_mod, "exact_search_host_reader_batch", slow_scan
        )
        t = threading.Thread(
            target=eng.search_embedding, args=(str(tmp_path / "big"), q, 5)
        )
        t.start()
        assert entered.wait(timeout=10)
        t0 = _time.perf_counter()
        s, i, _ = eng.search_embedding(str(tmp_path / "small"), q, 5)
        fast_s = _time.perf_counter() - t0
        t.join(timeout=15)
        np.testing.assert_array_equal(i, _oracle(small, q, 5)[1])
        assert fast_s < 0.8, (
            f"device-folder query took {fast_s:.2f}s — head-of-line "
            "blocked behind the host scan"
        )
    finally:
        eng.close()


def test_auto_budget_is_none_or_int(monkeypatch, tmp_path, device):
    eng = _engine(monkeypatch, tmp_path, budget_mb=0, device=device)
    assert eng._hbm_budget is None or isinstance(eng._hbm_budget, int)
    eng2 = _engine(monkeypatch, tmp_path, budget_mb=-1, device=device)
    assert eng2._hbm_budget is None
