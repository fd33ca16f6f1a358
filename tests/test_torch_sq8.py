"""The port's SQ8 capacity tier against the JAX package's, on the CPU.

Same seeded numpy inputs through both: quantization bit for bit, the
bound-sweep candidates (the port's plain version here; the CUDA kernel is
held against it in tests/test_torch_gpu.py and chip_smoke.py) against the
reference's Pallas kernel in interpret mode, the certified search, the
sidecar files in both directions, and the engine's over-budget route."""

import json
import os
import threading
import time
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from evossearch_tpu.index import sq8 as ref_sq8
from evossearch_tpu.index.store import IndexReader as RefReader
from evossearch_tpu.ops import topk_pallas as ref_topk
from evossearch_tpu_torch.core import Config
from evossearch_tpu_torch.core.constants import CLIPModelSpec
from evossearch_tpu_torch.engine import SearchEngine, _canon
from evossearch_tpu_torch.index.sq8 import (
    SQ8Index, quantize_rows, quantize_rows_device,
)
from evossearch_tpu_torch.index.store import IndexReader, IndexWriter, bf16_bits
from evossearch_tpu_torch.ops import topk

D = 256
SCORE_ATOL = 2e-6  # BLAS f32 reduction order of the two packages' reranks
# unit rows: the bounds' dot products are f32 sums in another order than
# XLA's (a few ulps of values below 1)
UNIT_ATOL = 1e-6


class FakeReader:
    """The reader contract SQ8Index needs (count, dim, dtype_name, root,
    shard_arrays); bf16 rows as the port holds them (uint16 bits)."""

    def __init__(self, emb, root="/nonexistent", dtype_name="float32", shards=1):
        self.count, self.dim = emb.shape
        self.dtype_name = dtype_name
        self.root = root
        cut = self.count // shards
        self._shards = [
            emb[i * cut : (i + 1) * cut if i < shards - 1 else self.count]
            for i in range(shards)
        ]

    def shard_arrays(self):
        return self._shards


def _unit(rng, n, d=D):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _oracle(emb, queries, k, bf16_query=False):
    """(score desc, index asc) top-k. Ranks by float64 row sums, the same
    order for every row (identical rows tie exactly); returns the float32
    scores of the host scan's contract."""
    qs = np.asarray(queries, np.float32)
    if bf16_query:
        qs = qs.astype(ml_dtypes.bfloat16).astype(np.float32)
    e = np.asarray(emb, np.float32)
    s64 = (e.astype(np.float64)[:, None, :] * qs.astype(np.float64)[None]).sum(-1)
    s32 = e @ qs.T
    order = [np.lexsort((np.arange(len(e)), -s64[:, j]))[:k] for j in range(len(qs))]
    return np.stack([s32[o, j] for j, o in enumerate(order)]), np.stack(order)


def _rows_of_reference_test():
    """The rows of tests/test_sq8.py:69-76: normal, heavy-tailed, constant,
    zero, 1e-30 and 1e-8-scaled rows, normalized."""
    rng = np.random.default_rng(0)
    rows = np.concatenate([
        rng.standard_normal((2000, D)).astype(np.float32),
        (rng.standard_normal((500, D)) ** 5).astype(np.float32),
        np.ones((3, D), np.float32),
        np.zeros((2, D), np.float32),
        np.full((2, D), 1e-30, np.float32),
        rng.standard_normal((500, D)).astype(np.float32) * 1e-8,
    ])
    norms = np.linalg.norm(rows, axis=1, keepdims=True)
    return np.where(norms > 0, rows / np.maximum(norms, 1e-30), rows)


def test_quantize_rows_equal_reference_and_rigorous():
    rows = _rows_of_reference_test()
    e8, scal2 = quantize_rows(rows)
    e8_r, scal2_r = ref_sq8.quantize_rows(rows)
    np.testing.assert_array_equal(e8, e8_r)
    np.testing.assert_array_equal(scal2, scal2_r)
    # rigor: u = dot*scale + radd*||q|| dominates the raw-f32-query score
    # and the bf16-query score, queries of any norm
    rng = np.random.default_rng(1)
    qs = rng.standard_normal((32, D)).astype(np.float32)
    qs[0] *= 100.0
    qs[1] *= 1e-6
    qb = qs.astype(ml_dtypes.bfloat16).astype(np.float32)
    qn = np.linalg.norm(qs, axis=1)
    dot = e8.astype(np.float32) @ qb.T
    u = dot * scal2[0][:, None] + scal2[1][:, None] * qn[None, :]
    for target in (rows @ qs.T, rows @ qb.T):
        assert not (u < target).any()


def test_quantize_rows_device_equals_host():
    rows = _rows_of_reference_test()
    e8, scal2 = quantize_rows(rows)
    e8_d, scal2_d = quantize_rows_device(torch.from_numpy(rows))
    np.testing.assert_array_equal(e8_d.numpy(), e8)
    np.testing.assert_array_equal(scal2_d[0].numpy(), scal2[0])
    # radd from f32 residual norms: within the inflation's margin
    np.testing.assert_allclose(scal2_d[1].numpy(), scal2[1], rtol=1e-5, atol=1e-9)
    e8_r, scal2_r = ref_sq8.quantize_rows_device(jnp.asarray(rows))
    np.testing.assert_array_equal(e8_d.numpy(), np.asarray(e8_r))


def _exact_sq8_inputs(seed, q):
    """int8 rows, power-of-two scales, queries of small integers over 16:
    every bound's dot is exact in f32, bounds tie for real."""
    rng = np.random.default_rng(seed)
    n = 3 * 512 + 100  # three tiles of 512 and a ragged tail
    e8 = rng.integers(-127, 128, (n, D)).astype(np.int8)
    e8[7::97] = e8[3]  # duplicate rows: equal bounds in one class
    scale = (2.0 ** -rng.integers(5, 10, n)).astype(np.float32)
    radd = (rng.random(n) * 1e-2).astype(np.float32)
    queries = (rng.integers(-4, 5, (q, D)) / 16).astype(np.float32)
    return e8, np.stack([scale, radd]), queries


def _ref_candidates(e8, scal2, queries, qn, tile_rows):
    q = len(queries)
    qp = np.zeros((ref_topk.LANES, D), np.float32)
    qp[:q] = queries
    qnp = np.zeros((ref_topk.LANES, 1), np.float32)
    qnp[:q, 0] = qn
    out = ref_topk.sq8_candidates(
        jnp.asarray(e8), jnp.asarray(scal2), jnp.asarray(qp), jnp.asarray(qnp),
        tile_rows, interpret=True)
    return [np.asarray(a)[:q] for a in out]


@pytest.mark.parametrize("q", [1, 7, 48])
def test_sq8_candidates_equal_pallas_exact_inputs(q):
    e8, scal2, queries = _exact_sq8_inputs(q, q)
    qn = np.linalg.norm(queries, axis=1).astype(np.float32)
    want = _ref_candidates(e8, scal2, queries, qn, 512)
    got = topk.sq8_candidates(torch.from_numpy(e8), torch.from_numpy(scal2),
                              torch.from_numpy(queries), torch.from_numpy(qn), 512)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)


def test_sq8_candidates_unit_rows_near_pallas():
    rng = np.random.default_rng(5)
    rows = _unit(rng, 2 * 1024 + 33)
    e8, scal2 = quantize_rows(rows)
    queries = _unit(rng, 9)
    qn = np.linalg.norm(queries, axis=1).astype(np.float32)
    want = _ref_candidates(e8, scal2, queries, qn, 1024)
    got = topk.sq8_candidates_plain(torch.from_numpy(e8), torch.from_numpy(scal2),
                                    torch.from_numpy(queries), torch.from_numpy(qn), 1024)
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=0, atol=UNIT_ATOL)
    np.testing.assert_allclose(got[2].numpy(), want[2], rtol=0, atol=UNIT_ATOL)
    # the rows of the candidates agree wherever the bounds are not near-tied
    agree = (got[1].numpy() == want[1]).mean()
    assert agree > 0.999
    # every candidate bound dominates its row's exact score (slots of the
    # tail past the corpus hold rows >= n at NEG_INF)
    s = rows @ queries.T
    cand_rows = got[1].numpy()
    real = cand_rows < len(rows)
    exact = np.take_along_axis(s.T, np.where(real, cand_rows, 0), axis=1)
    assert real.sum() > len(rows) // 4
    assert (got[0].numpy()[real] >= exact[real]).all()


def test_sq8_wrapper_checks_and_counts_no_cpu_launch():
    e8 = torch.zeros((1000, 128), dtype=torch.int8)
    scal2 = torch.ones((2, 1000))
    q = torch.zeros((2, 128))
    qn = torch.zeros(2)
    before = dict(topk.LAUNCHES)
    topk.sq8_candidates(e8, scal2, q, qn, 512)
    assert topk.LAUNCHES == before
    for bad in (
        lambda: topk.sq8_candidates(e8.float(), scal2, q, qn, 512),
        lambda: topk.sq8_candidates(e8[:, :100].contiguous(), scal2, q[:, :100], qn, 512),
        lambda: topk.sq8_candidates(e8, scal2[:, :10], q, qn, 512),
        lambda: topk.sq8_candidates(e8, scal2, torch.zeros((129, 128)), torch.zeros(129), 512),
        lambda: topk.sq8_candidates(e8, scal2, q, qn, 768),
        lambda: topk.sq8_candidates(e8, scal2, q, torch.zeros(3), 512),
    ):
        with pytest.raises(ValueError):
            bad()


def _both_indexes(emb_f32, dtype_name, shards):
    """The port's and the reference's SQ8Index over the same rows."""
    if dtype_name == "bfloat16":
        rows_p = bf16_bits(emb_f32)
        rows_r = emb_f32.astype(ml_dtypes.bfloat16)
        widened = rows_r.astype(np.float32)
    else:
        rows_p = rows_r = widened = emb_f32
    e8, scal2 = quantize_rows(widened)
    port = SQ8Index(e8, scal2, FakeReader(rows_p, dtype_name=dtype_name, shards=shards),
                    fetch=128, tile_rows=512)
    port.ensure_device("cpu")
    ref = ref_sq8.SQ8Index(e8, scal2, FakeReader(rows_r, dtype_name=dtype_name, shards=shards),
                           fetch=128, tile_rows=512)
    return port, ref, widened


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_search_batch_equals_reference_and_oracle(dtype_name):
    rng = np.random.default_rng(11)
    emb = _unit(rng, 12_000)
    port, ref, widened = _both_indexes(emb, dtype_name, shards=3)
    qs = _unit(rng, 6)
    k = 10
    s, i = port.search_batch(qs, k)
    s_r, i_r = ref.search_batch(qs, k)
    np.testing.assert_array_equal(i, i_r)
    np.testing.assert_allclose(s, s_r, rtol=0, atol=SCORE_ATOL)
    es, ei = _oracle(widened, qs, k, bf16_query=dtype_name == "bfloat16")
    np.testing.assert_array_equal(i, ei)
    np.testing.assert_allclose(s, es, rtol=0, atol=SCORE_ATOL)


def test_search_batch_chunks_past_128_queries():
    rng = np.random.default_rng(12)
    emb = _unit(rng, 3000)
    port, _, _ = _both_indexes(emb, "float32", shards=1)
    qs = _unit(rng, 130)
    s, i = port.search_batch(qs, 5)
    es, ei = _oracle(emb, qs, 5)
    np.testing.assert_array_equal(i, ei)
    assert s.shape == (130, 5)


def test_mass_ties_fall_back_and_stay_exact():
    """All-identical rows break every certificate; the host fallback still
    returns the lowest-index ties, and the counter sees it."""
    from evossearch_tpu_torch.utils import Counters

    rng = np.random.default_rng(3)
    row = rng.standard_normal(D).astype(np.float32)
    emb = np.tile(row / np.linalg.norm(row), (4096, 1))
    e8, scal2 = quantize_rows(emb)
    idx = SQ8Index(e8, scal2, FakeReader(emb), fetch=64, tile_rows=512)
    idx.counters = Counters()
    idx.ensure_device("cpu")
    s, i = idx.search_batch(emb[:1], 6)
    np.testing.assert_array_equal(i[0], np.arange(6))
    assert idx.counters.snapshot()["sq8_fallback_queries"] == 1


def test_search_needs_the_device_copy():
    emb = _unit(np.random.default_rng(13), 600)
    idx = SQ8Index(*quantize_rows(emb), FakeReader(emb), tile_rows=512)
    with pytest.raises(RuntimeError, match="ensure_device"):
        idx.search_batch(emb[:1], 3)


# -- sidecar files --


def _write_store(folder, emb, dtype_name="float32", seed=None):
    folder = Path(folder)
    folder.mkdir(exist_ok=True)
    w = IndexWriter.create(folder, model="tiny", dim=emb.shape[1], dtype_name=dtype_name)
    paths = [str(folder / f"img_{i:05d}.jpg") for i in range(len(emb))]
    w.append(emb, paths, [{"path": p, "mtime": 1.0, "size": 10} for p in paths])
    w.finalize()
    return emb


def test_sidecar_roundtrip_and_anomalies(tmp_path):
    emb = _unit(np.random.default_rng(4), 5000)
    reader = FakeReader(emb, root=str(tmp_path), shards=2)
    built = SQ8Index.build_from_reader(reader)
    loaded = SQ8Index.load(reader)
    assert loaded is not None
    np.testing.assert_array_equal(np.asarray(loaded.e8), np.asarray(built.e8))
    np.testing.assert_array_equal(loaded.scal2, built.scal2)
    assert not list(tmp_path.glob("*.tmp"))
    meta = json.loads((tmp_path / "sq8.json").read_text())
    meta["count"] = 5001
    (tmp_path / "sq8.json").write_text(json.dumps(meta))
    assert SQ8Index.load(reader) is None
    meta["count"] = 5000
    (tmp_path / "sq8.json").write_text(json.dumps(meta))
    assert SQ8Index.load(reader) is not None
    with open(tmp_path / "sq8.bin", "r+b") as f:
        f.truncate(100)
    assert SQ8Index.load(reader) is None
    (tmp_path / "sq8.json").unlink()
    assert SQ8Index.load(reader) is None


def test_store_mtime_stamp_rejects_cross_generation_sidecar(tmp_path):
    folder = tmp_path / "a"
    _write_store(folder, _unit(np.random.default_rng(6), 500))
    reader = IndexReader.open(folder)
    SQ8Index.build_from_reader(reader, store_mtime=123.0)
    assert SQ8Index.load(reader, store_mtime=123.0) is not None
    assert SQ8Index.load(reader, store_mtime=124.0) is None
    assert SQ8Index.load(reader) is not None
    meta_p = folder / ".clip_index" / "sq8.json"
    meta = json.loads(meta_p.read_text())
    del meta["store_mtime"]
    meta_p.write_text(json.dumps(meta))
    assert SQ8Index.load(reader, store_mtime=999.0) is not None


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_sidecars_cross_load_and_match_byte_for_byte(tmp_path, dtype_name):
    emb = _unit(np.random.default_rng(7), 3000)
    a, b = tmp_path / "a", tmp_path / "b"
    _write_store(a, emb, dtype_name)
    _write_store(b, emb, dtype_name)
    port_a, ref_a = IndexReader.open(a), RefReader.open(a)
    port_b, ref_b = IndexReader.open(b), RefReader.open(b)
    SQ8Index.build_from_reader(port_a, store_mtime=5.0, chunk=1000)
    ref_sq8.SQ8Index.build_from_reader(ref_b, store_mtime=5.0, chunk=1000)
    for name in ("sq8.bin", "sq8_scales.bin", "sq8.json"):
        assert (a / ".clip_index" / name).read_bytes() == (b / ".clip_index" / name).read_bytes()
    # the reference's sidecar loads in the port, and the port's in the
    # reference
    from_ref = SQ8Index.load(port_b, store_mtime=5.0)
    from_port = ref_sq8.SQ8Index.load(ref_a, store_mtime=5.0)
    assert from_ref is not None and from_port is not None
    np.testing.assert_array_equal(np.asarray(from_ref.e8), np.asarray(from_port.e8))
    np.testing.assert_array_equal(from_ref.scal2, from_port.scal2)


# -- the engine's over-budget route (tests/test_sq8.py:236-520, ported) --

TINY = CLIPModelSpec(
    name="tiny", image_size=64, patch_size=16, vision_width=64,
    vision_layers=2, vision_heads=4, text_width=48, text_layers=2,
    text_heads=4, vocab_size=49408, context_length=77, embed_dim=D,
)
N_ENGINE = 7000  # 7.2 MB of f32 corpus, a 1.85 MB sidecar


def _make_index(folder, n, seed):
    return _write_store(folder, _unit(np.random.default_rng(seed), n))


def _engine(monkeypatch, tmp_path, budget_mb, microbatch_ms="0", **env):
    for key in list(os.environ):
        if key.startswith("EVOSSEARCH_"):
            monkeypatch.delenv(key)
    monkeypatch.setenv("EVOSSEARCH_HBM_BUDGET_MB", str(budget_mb))
    monkeypatch.setenv("EVOSSEARCH_SEARCH_KERNEL", "xla")
    monkeypatch.setenv("EVOSSEARCH_MICROBATCH_MS", microbatch_ms)
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    return SearchEngine(cfg=Config(env_path=tmp_path / "missing.env"), spec=TINY,
                        device="cpu")


def _query(seed):
    q = np.random.default_rng(seed).standard_normal(D).astype(np.float32)
    return q / np.linalg.norm(q)


def test_engine_routes_over_budget_folder_to_sq8(monkeypatch, tmp_path):
    """Under the default EVOSSEARCH_SQ8=auto a folder over its budget is
    served by the tier: counter, sidecar on disk, device bytes, and the
    host exact scan's results."""
    folder = tmp_path / "a"
    emb = _make_index(folder, N_ENGINE, seed=0)
    eng = _engine(monkeypatch, tmp_path, budget_mb=2)
    assert eng.cfg.SQ8 == "auto"
    q = _query(7)
    s, i, _ = eng.search_embedding(str(folder), q, 10)
    es, ei = _oracle(emb, q[None], 10)
    np.testing.assert_array_equal(i, ei[0])
    np.testing.assert_allclose(s, es[0], rtol=0, atol=SCORE_ATOL)
    from evossearch_tpu_torch.index.search import exact_search_host_reader_batch

    hs, hi = exact_search_host_reader_batch(IndexReader.open(folder), q[None], 10)
    np.testing.assert_array_equal(i, hi[0])
    entry = eng._index_cache[_canon(str(folder))]
    assert "emb" not in entry and entry["sq8"] is not None
    assert entry["device_bytes"] == entry["sq8"].device_bytes() == N_ENGINE * (D + 8)
    snap = eng.counters.snapshot()
    assert snap["sq8_queries"] == 1 and snap["host_routed_queries"] == 1
    assert (folder / ".clip_index" / "sq8.bin").exists()
    assert not list((folder / ".clip_index").glob("*.tmp"))
    # a second engine loads the persisted sidecar instead of rebuilding
    mtime = (folder / ".clip_index" / "sq8.json").stat().st_mtime
    eng2 = _engine(monkeypatch, tmp_path, budget_mb=2)
    s2, i2, _ = eng2.search_embedding(str(folder), q, 10)
    np.testing.assert_array_equal(i2, ei[0])
    assert (folder / ".clip_index" / "sq8.json").stat().st_mtime == mtime


def test_engine_sq8_off_and_too_big_fall_to_host_scan(monkeypatch, tmp_path):
    folder = tmp_path / "a"
    emb = _make_index(folder, N_ENGINE, seed=1)
    eng = _engine(monkeypatch, tmp_path, budget_mb=1)  # sidecar does not fit
    q = _query(9)
    s, i, _ = eng.search_embedding(str(folder), q, 5)
    np.testing.assert_array_equal(i, _oracle(emb, q[None], 5)[1][0])
    entry = eng._index_cache[_canon(str(folder))]
    assert entry["sq8"] is None and entry.get("device_bytes", 0) == 0
    assert "sq8_queries" not in eng.counters.snapshot()
    eng2 = _engine(monkeypatch, tmp_path, budget_mb=2, EVOSSEARCH_SQ8="off")
    s, i, _ = eng2.search_embedding(str(folder), q, 5)
    np.testing.assert_array_equal(i, _oracle(emb, q[None], 5)[1][0])
    assert eng2._index_cache[_canon(str(folder))]["sq8"] is None
    assert not (folder / ".clip_index" / "sq8.json").exists()


def test_engine_sq8_sidecar_invalidated_by_reindex(monkeypatch, tmp_path):
    folder = tmp_path / "a"
    _make_index(folder, N_ENGINE, seed=2)
    eng = _engine(monkeypatch, tmp_path, budget_mb=2)
    q = _query(11)
    eng.search_embedding(str(folder), q, 5)
    sidecar = folder / ".clip_index" / "sq8.json"
    assert sidecar.exists()
    time.sleep(0.02)
    emb2 = _make_index(folder, N_ENGINE, seed=3)
    now = time.time() + 1
    os.utime(folder / ".clip_index" / "manifest.json", (now, now))
    eng2 = _engine(monkeypatch, tmp_path, budget_mb=2)
    s, i, _ = eng2.search_embedding(str(folder), q, 5)
    np.testing.assert_array_equal(i, _oracle(emb2, q[None], 5)[1][0])
    assert sidecar.stat().st_mtime >= now - 2  # rebuilt


def test_engine_sq8_batcher_path(monkeypatch, tmp_path):
    """Micro-batched submissions, one and several at once, reach the
    same route."""
    folder = tmp_path / "a"
    emb = _make_index(folder, N_ENGINE, seed=4)
    eng = _engine(monkeypatch, tmp_path, budget_mb=2, microbatch_ms="5")
    try:
        q = _query(13)
        s, i, _ = eng.search_embedding(str(folder), q, 5)
        np.testing.assert_array_equal(i, _oracle(emb, q[None], 5)[1][0])
        qs = [_query(100 + j) for j in range(6)]
        out = [None] * len(qs)

        def run(j):
            out[j] = eng.search_embedding(str(folder), torch.from_numpy(qs[j]), 7)

        threads = [threading.Thread(target=run, args=(j,)) for j in range(len(qs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        _, ei = _oracle(emb, np.stack(qs), 7)
        for j, (_, i, _) in enumerate(out):
            np.testing.assert_array_equal(i, ei[j])
        assert eng.counters.snapshot()["sq8_queries"] == 1 + len(qs)
    finally:
        eng.close()


def test_engine_sq8_async_build_over_sync_threshold(monkeypatch, tmp_path):
    folder = tmp_path / "a"
    emb = _make_index(folder, N_ENGINE, seed=5)
    eng = _engine(monkeypatch, tmp_path, budget_mb=2, EVOSSEARCH_SQ8_SYNC_ROWS="1000")
    q = _query(21)
    _, ei = _oracle(emb, q[None], 10)
    s, i, _ = eng.search_embedding(str(folder), q, 10)
    np.testing.assert_array_equal(i, ei[0])  # host scan, still exact
    snap = eng.counters.snapshot()
    assert snap["sq8_async_builds"] == 1 and snap.get("sq8_queries", 0) == 0
    entry = eng._index_cache[_canon(str(folder))]
    deadline = time.time() + 60
    while time.time() < deadline:
        with entry["lock"]:
            if not entry.get("sq8_building") and "sq8" in entry:
                break
        time.sleep(0.02)
    assert entry.get("sq8") is not None
    s2, i2, _ = eng.search_embedding(str(folder), q, 10)
    np.testing.assert_array_equal(i2, ei[0])
    snap = eng.counters.snapshot()
    assert snap["sq8_queries"] == 1 and snap["sq8_async_builds"] == 1


def test_engine_counts_sq8_fallbacks(monkeypatch, tmp_path):
    """A mass-tie corpus (3500 identical rows) fails the class certificate:
    the query falls back to the host scan and the counter records it. The
    result is the host scan's, which scores the identical rows with BLAS
    and so orders them by its rounding noise: it holds against the
    float64 oracle up to that noise (scores within SCORE_ATOL, every row
    one of the identical ones). The reference's own test of this asserts
    the oracle's order of the tied rows and fails in the reference."""
    folder = tmp_path / "a"
    rng = np.random.default_rng(31)
    emb = _unit(rng, N_ENGINE)
    emb[::2] = emb[0]
    _write_store(folder, emb)
    eng = _engine(monkeypatch, tmp_path, budget_mb=2)
    q = emb[0] + 1e-5 * rng.standard_normal(D).astype(np.float32)
    q = (q / np.linalg.norm(q)).astype(np.float32)
    s, i, _ = eng.search_embedding(str(folder), q, 48)
    from evossearch_tpu_torch.index.search import exact_search_host_reader_batch

    hs, hi = exact_search_host_reader_batch(IndexReader.open(folder), q[None], 48)
    np.testing.assert_array_equal(i, hi[0])
    np.testing.assert_array_equal(s, hs[0])
    es, ei = _oracle(emb, q[None], 48)
    np.testing.assert_array_equal(ei[0], np.arange(0, 96, 2))
    np.testing.assert_allclose(s, es[0], rtol=0, atol=SCORE_ATOL)
    assert (i % 2 == 0).all() and len(set(i.tolist())) == 48
    snap = eng.counters.snapshot()
    assert snap["sq8_queries"] == 1
    assert snap["sq8_fallback_queries"] == 1


def test_stats_hbm_snapshot(monkeypatch, tmp_path):
    folder = tmp_path / "a"
    _make_index(folder, N_ENGINE, seed=9)
    eng = _engine(monkeypatch, tmp_path, budget_mb=2)
    eng.search_embedding(str(folder), _query(33), 5)
    snap = eng.hbm_snapshot()
    assert snap["budget_bytes"] == 2 << 20
    (fo,) = snap["folders"].values()
    assert fo["tiers"] == ["sq8"] and fo["fits_device"] is False
    assert snap["reserved_bytes"] == fo["device_bytes"] == N_ENGINE * (D + 8)


def test_eviction_drops_the_sq8_tier(monkeypatch, tmp_path):
    """A second over-budget folder's sidecar evicts the first one's."""
    a, b = tmp_path / "a", tmp_path / "b"
    _make_index(a, N_ENGINE, seed=10)
    emb_b = _make_index(b, N_ENGINE, seed=12)
    eng = _engine(monkeypatch, tmp_path, budget_mb=3)  # one sidecar fits
    eng.search_embedding(str(a), _query(1), 5)
    entry_a = eng._index_cache[_canon(str(a))]
    assert entry_a.get("sq8") is not None
    q = _query(2)
    s, i, _ = eng.search_embedding(str(b), q, 5)
    np.testing.assert_array_equal(i, _oracle(emb_b, q[None], 5)[1][0])
    assert "sq8" not in entry_a and entry_a["device_bytes"] == 0
    assert eng.counters.snapshot()["hbm_evictions"] == 1


def _slow_build(monkeypatch, hook):
    orig = SQ8Index.build_from_reader.__func__

    def build(cls, reader, **kw):
        return hook(lambda: orig(cls, reader, **kw))

    monkeypatch.setattr(SQ8Index, "build_from_reader", classmethod(build))


def test_async_build_discards_install_when_entry_orphaned(monkeypatch, tmp_path):
    folder = tmp_path / "a"
    _make_index(folder, N_ENGINE, seed=41)
    eng = _engine(monkeypatch, tmp_path, budget_mb=2, EVOSSEARCH_SQ8_SYNC_ROWS="1000")
    release = threading.Event()

    def hook(build):
        release.wait(30)
        return build()

    _slow_build(monkeypatch, hook)
    eng.search_embedding(str(folder), _query(43), 5)  # starts the build
    entry = eng._index_cache[_canon(str(folder))]
    assert entry.get("sq8_building") is True
    eng._index_cache.pop(_canon(str(folder)))  # orphan it (re-index/evict)
    release.set()
    deadline = time.time() + 30
    while time.time() < deadline and entry.get("sq8_building"):
        time.sleep(0.02)
    assert entry.get("sq8") is None
    assert entry.get("device_bytes", 0) == 0


def test_async_build_skips_install_when_query_already_installed(monkeypatch, tmp_path):
    folder = tmp_path / "a"
    _make_index(folder, N_ENGINE, seed=51)
    eng = _engine(monkeypatch, tmp_path, budget_mb=2, EVOSSEARCH_SQ8_SYNC_ROWS="1000")
    published = threading.Event()
    release = threading.Event()

    def hook(build):
        out = build()  # the files are on disk now
        published.set()
        release.wait(30)  # hold the build thread before it takes the lock
        return out

    _slow_build(monkeypatch, hook)
    q = _query(53)
    eng.search_embedding(str(folder), q, 5)
    assert published.wait(30)
    eng.search_embedding(str(folder), q, 5)  # loads the published files
    entry = eng._index_cache[_canon(str(folder))]
    assert entry.get("sq8") is not None
    need = N_ENGINE * (D + 8)
    assert entry["device_bytes"] == need
    release.set()
    deadline = time.time() + 30
    while time.time() < deadline and entry.get("sq8_building"):
        time.sleep(0.02)
    assert entry["device_bytes"] == need  # the build thread did not reserve again
