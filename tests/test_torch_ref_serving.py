"""The port's micro-batched serving path: tests/test_serving.py held
against evossearch_tpu_torch. Result equivalence with the unbatched
kernel, actual grouping of concurrent requests, per-folder isolation.

The engine's tests run on the CPU and, marked ``gpu``, on the card (the
``device`` fixture), where the batchers copy their stacked queries to the
card. Harness only: each engine is given its device. Imports neither JAX
nor the JAX package."""

import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

from evossearch_tpu_torch.core import Config
from evossearch_tpu_torch.core.constants import CLIPModelSpec
from evossearch_tpu_torch.engine import SearchEngine
from evossearch_tpu_torch.serving import MicroBatcher

TINY = CLIPModelSpec(
    name="tiny", image_size=64, patch_size=16, vision_width=64,
    vision_layers=2, vision_heads=4, text_width=48, text_layers=2,
    text_heads=4, vocab_size=49408, context_length=77, embed_dim=32,
)


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return request.param


def test_microbatcher_groups_and_matches_oracle():
    rng = np.random.default_rng(0)
    corpora = {
        "/a": rng.standard_normal((200, 16)).astype(np.float32),
        "/b": rng.standard_normal((150, 16)).astype(np.float32),
    }
    calls = []

    def execute(folder, queries, k):
        calls.append((folder, queries.shape[0]))
        time.sleep(0.03)  # simulate a device dispatch: while it runs,
        # concurrent submissions accumulate and batch naturally
        scores = queries @ corpora[folder].T
        order = np.argsort(-scores, axis=1, kind="stable")[:, :k]
        return np.take_along_axis(scores, order, axis=1), order

    mb = MicroBatcher(execute, window_ms=30.0)
    try:
        queries = rng.standard_normal((12, 16)).astype(np.float32)
        results = [None] * 12
        threads = []
        for i in range(12):
            folder = "/a" if i % 3 else "/b"

            def run(i=i, folder=folder):
                results[i] = (folder, mb.submit(folder, queries[i], 5))

            threads.append(threading.Thread(target=run))
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        # every result matches its own single-query oracle
        for i, (folder, (scores, idx)) in enumerate(results):
            exp_scores = queries[i] @ corpora[folder].T
            exp_order = np.argsort(-exp_scores, kind="stable")[:5]
            np.testing.assert_array_equal(idx, exp_order)
        # and requests were actually grouped: far fewer dispatches than 12
        assert len(calls) < 12
        assert sum(n for _, n in calls) == 12
        # groups never mix folders
        assert all(f in ("/a", "/b") for f, _ in calls)
    finally:
        mb.close()


def test_steady_load_settle_fills_batches():
    """Closed-loop clients re-submit staggered just after a round ends;
    without the settle the worker alternates 1-then-(n-1) sized batches
    (it dispatches the first straggler alone). With the growth-settle the
    wave coalesces: ~one dispatch per round of clients. Results must stay
    correct either way; the dispatch count is the regression signal."""
    rng = np.random.default_rng(7)
    corpus = rng.standard_normal((100, 16)).astype(np.float32)
    calls = []

    def execute(folder, queries, k):
        calls.append(queries.shape[0])
        time.sleep(0.03)  # the device round trip IS the rate limiter
        scores = queries @ corpus.T
        order = np.argsort(-scores, axis=1, kind="stable")[:, :k]
        return np.take_along_axis(scores, order, axis=1), order

    n_threads, n_rounds = 6, 4
    queries = rng.standard_normal((n_threads, 16)).astype(np.float32)
    mb = MicroBatcher(execute, window_ms=2.0)
    try:
        ok = []

        def client(i):
            for _ in range(n_rounds):
                s, idx = mb.submit("/f", queries[i], 5)
                exp = np.argsort(-(queries[i] @ corpus.T), kind="stable")[:5]
                ok.append(bool((idx == exp).all()))
                time.sleep(0.001)  # per-request host work -> staggered wave

        ts = [threading.Thread(target=client, args=(i,))
              for i in range(n_threads)]
        [t.start() for t in ts]
        [t.join() for t in ts]
        assert all(ok) and len(ok) == n_threads * n_rounds
        assert sum(calls) == n_threads * n_rounds
        # un-settled alternation would need ~2 dispatches per round
        # (1 + n-1); the settle gets ~1. Loose bound: < 1.5x rounds + warmup.
        assert len(calls) <= n_rounds + n_rounds // 2 + 2, calls
    finally:
        mb.close()


def test_solo_sequential_client_skips_settle(monkeypatch):
    """A lone closed-loop client (the reference's one-user workload) must
    never pay the steady-load settle: each round is a solo query leaving
    no backlog, so the worker dispatches the next one immediately instead
    of sleeping through the ~8 ms no-growth grace per request."""
    import time as time_mod

    real_sleep = time_mod.sleep
    settle_sleeps = []

    def spy_sleep(dt):
        # only the batcher worker's settle loop calls time.sleep here
        if threading.current_thread().name == "query-microbatcher":
            settle_sleeps.append(dt)
        real_sleep(dt)

    monkeypatch.setattr(time_mod, "sleep", spy_sleep)
    rng = np.random.default_rng(3)
    corpus = rng.standard_normal((64, 16)).astype(np.float32)

    def execute(folder, queries, k):
        scores = queries @ corpus.T
        order = np.argsort(-scores, axis=1, kind="stable")[:, :k]
        return np.take_along_axis(scores, order, axis=1), order

    mb = MicroBatcher(execute, window_ms=2.0)
    try:
        q = rng.standard_normal((6, 16)).astype(np.float32)
        for i in range(6):  # back-to-back: well inside the 50 ms window
            s, idx = mb.submit("/f", q[i], 5)
            exp = np.argsort(-(q[i] @ corpus.T), kind="stable")[:5]
            assert (idx == exp).all()
        assert settle_sleeps == [], settle_sleeps
        assert mb.dispatches == 6  # every solo query went out immediately
    finally:
        mb.close()


def test_batcher_propagates_errors():
    def execute(folder, queries, k):
        raise LookupError("Folder not indexed")

    mb = MicroBatcher(execute, window_ms=1.0)
    try:
        with pytest.raises(LookupError):
            mb.submit("/nope", np.zeros(4, np.float32), 3)
    finally:
        mb.close()


def test_engine_microbatched_equals_direct(tmp_path, monkeypatch, device):
    rng = np.random.default_rng(1)
    for i in range(8):
        arr = rng.integers(0, 256, (50, 70, 3), dtype=np.uint8)
        Image.fromarray(arr).save(tmp_path / f"i{i}.jpg", quality=90)
    monkeypatch.setenv("EVOSSEARCH_COMPUTE_DTYPE", "float32")
    monkeypatch.setenv("EVOSSEARCH_SEARCH_KERNEL", "xla")

    monkeypatch.setenv("EVOSSEARCH_MICROBATCH_MS", "0")  # direct
    direct = SearchEngine(cfg=Config(env_path=None), spec=TINY, device=device)
    assert direct.index_folder(str(tmp_path)) == 8
    q = direct.encode_text("query")
    s0, i0, _ = direct.search_embedding(str(tmp_path), q, 4)

    monkeypatch.setenv("EVOSSEARCH_MICROBATCH_MS", "2.0")
    batched = SearchEngine(cfg=Config(env_path=None), spec=TINY, device=device)
    s1, i1, _ = batched.search_embedding(str(tmp_path), q, 4)
    np.testing.assert_array_equal(i1, i0)
    np.testing.assert_allclose(s1, s0, atol=1e-5)
    assert batched._batcher.dispatches >= 1


def test_engine_ivf_through_batcher(tmp_path, monkeypatch, device):
    """IVF searches route through the MicroBatcher (round-2): batched
    results must equal the direct IVF path, concurrent queries must all
    succeed, and short-probe padding (-1 ids) must be filtered out."""
    import threading

    rng = np.random.default_rng(2)
    for i in range(10):
        arr = rng.integers(0, 256, (50, 70, 3), dtype=np.uint8)
        Image.fromarray(arr).save(tmp_path / f"i{i}.jpg", quality=90)
    monkeypatch.setenv("EVOSSEARCH_COMPUTE_DTYPE", "float32")
    monkeypatch.setenv("EVOSSEARCH_INDEX_KIND", "ivf")
    # nprobe=1 over many tiny lists -> probes cover < k rows, exercising
    # the -1 padding filter after the batcher's row slicing
    monkeypatch.setenv("EVOSSEARCH_IVF_NLIST", "8")
    monkeypatch.setenv("EVOSSEARCH_IVF_NPROBE", "1")

    monkeypatch.setenv("EVOSSEARCH_MICROBATCH_MS", "0")  # direct
    direct = SearchEngine(cfg=Config(env_path=None), spec=TINY, device=device)
    assert direct.index_folder(str(tmp_path)) == 10
    q = direct.encode_text("query")
    s0, i0, _ = direct.search_embedding(str(tmp_path), q, 6)
    assert 0 < len(i0) <= 6 and (i0 >= 0).all()

    monkeypatch.setenv("EVOSSEARCH_MICROBATCH_MS", "2.0")
    batched = SearchEngine(cfg=Config(env_path=None), spec=TINY, device=device)
    results = {}

    def hit(tag, text):
        qv = batched.encode_text(text)
        results[tag] = batched.search_embedding(str(tmp_path), qv, 6)

    ts = [threading.Thread(target=hit, args=(t, t))
          for t in ("a", "b", "c", "query")]
    [t.start() for t in ts]
    [t.join() for t in ts]
    assert batched._batcher.dispatches >= 1
    for tag, (s, i, _) in results.items():
        assert len(s) == len(i) and (i >= 0).all(), tag
    s1, i1, _ = results["query"]
    np.testing.assert_array_equal(i1, i0)
    np.testing.assert_allclose(s1, s0, atol=1e-5)


def test_fused_text_search_equals_direct(tmp_path, monkeypatch, device):
    """Fresh-text searches ride the fused one-dispatch encode+search
    batcher; concurrent queries group, every result matches the direct
    (unbatched two-stage) path, and the fused pass seeds the text cache
    so a repeat query skips the tower."""
    import threading

    rng = np.random.default_rng(3)
    for i in range(9):
        arr = rng.integers(0, 256, (50, 70, 3), dtype=np.uint8)
        Image.fromarray(arr).save(tmp_path / f"i{i}.jpg", quality=90)
    monkeypatch.setenv("EVOSSEARCH_COMPUTE_DTYPE", "float32")
    monkeypatch.setenv("EVOSSEARCH_SEARCH_KERNEL", "xla")

    monkeypatch.setenv("EVOSSEARCH_MICROBATCH_MS", "0")  # direct
    direct = SearchEngine(cfg=Config(env_path=None), spec=TINY, device=device)
    assert direct.index_folder(str(tmp_path)) == 9
    texts = [f"fused query {i}" for i in range(10)]
    want = {t: direct.search_text(str(tmp_path), t, 4) for t in texts}

    monkeypatch.setenv("EVOSSEARCH_MICROBATCH_MS", "2.0")
    batched = SearchEngine(cfg=Config(env_path=None), spec=TINY, device=device)
    got = {}
    lock = threading.Lock()

    def hit(t):
        res = batched.search_text(str(tmp_path), t, 4)
        with lock:
            got[t] = res

    ts = [threading.Thread(target=hit, args=(t,)) for t in texts]
    [t.start() for t in ts]
    [t.join() for t in ts]
    for t in texts:
        s0, i0, _ = want[t]
        s1, i1, _ = got[t]
        np.testing.assert_array_equal(i1, i0, err_msg=t)
        np.testing.assert_allclose(s1, s0, atol=1e-5)
    fb = batched._fused_batcher
    assert fb is not None and fb.batched_queries == len(texts)
    assert fb.dispatches >= 1
    # repeat query = text-cache hit: no new fused dispatch
    before = fb.dispatches
    s2, i2, _ = batched.search_text(str(tmp_path), texts[0], 4)
    np.testing.assert_array_equal(i2, want[texts[0]][1])
    assert fb.dispatches == before
    assert batched.counters.snapshot().get("text_cache_hits", 0) >= 1
    batched.close()
    direct.close()
    # post-close fused submits fail fast instead of hanging
    with pytest.raises(RuntimeError):
        fb.submit(str(tmp_path), np.zeros(TINY.context_length, np.int32), 2)


def test_fused_text_search_ineligible_routes_fall_back(tmp_path, monkeypatch, device):
    """Folders the fused program can't serve (IVF kind here) still answer
    fresh-text searches correctly through the encode-then-route path."""
    rng = np.random.default_rng(4)
    for i in range(10):
        arr = rng.integers(0, 256, (50, 70, 3), dtype=np.uint8)
        Image.fromarray(arr).save(tmp_path / f"i{i}.jpg", quality=90)
    monkeypatch.setenv("EVOSSEARCH_COMPUTE_DTYPE", "float32")
    monkeypatch.setenv("EVOSSEARCH_INDEX_KIND", "ivf")
    monkeypatch.setenv("EVOSSEARCH_IVF_NLIST", "2")
    monkeypatch.setenv("EVOSSEARCH_IVF_NPROBE", "2")

    monkeypatch.setenv("EVOSSEARCH_MICROBATCH_MS", "0")
    direct = SearchEngine(cfg=Config(env_path=None), spec=TINY, device=device)
    assert direct.index_folder(str(tmp_path)) == 10
    s0, i0, _ = direct.search_text(str(tmp_path), "fallback", 5)

    monkeypatch.setenv("EVOSSEARCH_MICROBATCH_MS", "2.0")
    batched = SearchEngine(cfg=Config(env_path=None), spec=TINY, device=device)
    s1, i1, _ = batched.search_text(str(tmp_path), "fallback", 5)
    np.testing.assert_array_equal(i1, i0)
    np.testing.assert_allclose(s1, s0, atol=1e-5)
    fb = batched.__dict__.get("_fused_batcher_inst")
    assert fb is None or fb.dispatches == 0  # routed around the fused path
    batched.close()
    direct.close()


def test_text_encode_batcher_equivalence(tmp_path, monkeypatch, device):
    """Concurrent text encodes through the TextEncodeBatcher must be
    numerically equivalent to the direct single-text path (the batched
    pass runs one fixed (max_batch, ctx) shape, whose XLA tiling may
    round differently from the (1, ctx) program) and must group
    dispatches."""
    import threading

    monkeypatch.setenv("EVOSSEARCH_COMPUTE_DTYPE", "float32")
    monkeypatch.setenv("EVOSSEARCH_MICROBATCH_MS", "0")  # direct
    direct = SearchEngine(cfg=Config(env_path=None), spec=TINY, device=device)
    texts = [f"query number {i}" for i in range(12)]
    want = {t: direct.encode_text(t) for t in texts}

    monkeypatch.setenv("EVOSSEARCH_MICROBATCH_MS", "2.0")
    batched = SearchEngine(cfg=Config(env_path=None), spec=TINY, device=device)
    got = {}
    lock = threading.Lock()

    def hit(t):
        e = batched.encode_text(t)
        with lock:
            got[t] = e

    ts = [threading.Thread(target=hit, args=(t,)) for t in texts]
    [t.start() for t in ts]
    [t.join() for t in ts]
    for t in texts:
        np.testing.assert_allclose(got[t], want[t], atol=1e-6)
    tb = batched._text_batcher
    assert tb is not None and tb.dispatches >= 1
    assert tb.batched_queries == len(texts)
    batched.close()
    direct.close()
    # post-close submits fail fast instead of hanging
    import pytest as _pytest
    with _pytest.raises(RuntimeError):
        tb.submit(np.zeros(TINY.context_length, np.int32))
