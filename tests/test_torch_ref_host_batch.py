"""The port against tests/test_host_batch.py: batched host exact scan:
one GEMM sweep per shard for a whole query batch, same tie contract
(score desc, index asc) as every other kernel.

Nothing to adapt: the package is renamed.
"""

import numpy as np
import pytest

from evossearch_tpu_torch.index import IndexReader, IndexWriter
from evossearch_tpu_torch.index.search import (
    exact_search_host_batch,
    exact_search_host_reader,
    exact_search_host_reader_batch,
)


def _oracle(emb, q, k):
    scores = emb.astype(np.float32) @ q
    order = np.lexsort((np.arange(len(scores)), -scores))[:k]
    return scores[order], order


@pytest.mark.parametrize("n,k", [(300, 10), (50, 50), (50, 80), (1, 1)])
def test_host_batch_matches_oracle(n, k):
    rng = np.random.default_rng(n)
    emb = rng.standard_normal((n, 16)).astype(np.float32)
    queries = rng.standard_normal((5, 16)).astype(np.float32)
    s, i = exact_search_host_batch(emb, queries, k)
    kk = min(k, n)
    assert s.shape == (5, kk) and i.shape == (5, kk)
    for qi in range(5):
        es, ei = _oracle(emb, queries[qi], kk)
        np.testing.assert_array_equal(i[qi], ei)
        # GEMM vs matvec summation order differs in the last ulp
        np.testing.assert_allclose(s[qi], es, rtol=1e-5, atol=1e-6)


def test_host_batch_adversarial_ties():
    # constant rows: every score identical -> the k lowest indices win
    emb = np.ones((97, 8), np.float32)
    queries = np.ones((3, 8), np.float32)
    s, i = exact_search_host_batch(emb, queries, 12)
    for qi in range(3):
        np.testing.assert_array_equal(i[qi], np.arange(12))


def test_host_batch_tie_blocks():
    # two interleaved score levels across the block boundary
    rng = np.random.default_rng(0)
    emb = np.tile(np.eye(4, dtype=np.float32), (25, 1))  # 100 rows, 4 levels
    q = np.array([[2.0, 1.0, 0.0, -1.0]], np.float32)
    s, i = exact_search_host_batch(emb, q, 30)
    es, ei = _oracle(emb, q[0], 30)
    np.testing.assert_array_equal(i[0], ei)


def test_host_batch_bf16_quantizes_query():
    import ml_dtypes

    rng = np.random.default_rng(7)
    emb = rng.standard_normal((200, 16)).astype(ml_dtypes.bfloat16)
    q = rng.standard_normal((2, 16)).astype(np.float32)
    s, i = exact_search_host_batch(emb, q, 9)
    qq = q.astype(ml_dtypes.bfloat16).astype(np.float32)
    for qi in range(2):
        es, ei = _oracle(np.asarray(emb, np.float32), qq[qi], 9)
        np.testing.assert_array_equal(i[qi], ei)


def test_host_batch_empty_edges():
    emb = np.zeros((10, 4), np.float32)
    s, i = exact_search_host_batch(emb, np.zeros((0, 4), np.float32), 5)
    assert s.shape == (0, 5) and i.shape == (0, 5)
    s, i = exact_search_host_batch(emb, np.zeros((2, 4), np.float32), 0)
    assert s.shape == (2, 0)


def _store(tmp_path, n, d, dtype_name="float32", rows_per_shard=16, seed=3):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((n, d)).astype(np.float32)
    w = IndexWriter.create(
        tmp_path, model="m", dim=d,
        dtype_name=dtype_name, rows_per_shard=rows_per_shard,
    )
    w.append(emb, [f"/p/{i}" for i in range(n)],
             [{"path": str(i)} for i in range(n)])
    w.finalize()
    return emb, IndexReader.open(tmp_path)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_reader_batch_matches_single_query_scan(tmp_path, dtype_name):
    _, reader = _store(tmp_path, 70, 16, dtype_name=dtype_name)
    rng = np.random.default_rng(9)
    queries = rng.standard_normal((6, 16)).astype(np.float32)
    bs, bi = exact_search_host_reader_batch(reader, queries, 20)
    assert bs.shape == (6, 20)
    for qi in range(6):
        ss, si = exact_search_host_reader(reader, queries[qi], 20)
        np.testing.assert_array_equal(bi[qi], si)
        np.testing.assert_allclose(bs[qi], ss, rtol=1e-5, atol=1e-6)


def test_reader_batch_single_row_uses_native_path(tmp_path):
    _, reader = _store(tmp_path, 40, 8, seed=5)
    q = np.random.default_rng(6).standard_normal((1, 8)).astype(np.float32)
    s, i = exact_search_host_reader_batch(reader, q, 7)
    ss, si = exact_search_host_reader(reader, q[0], 7)
    np.testing.assert_array_equal(i[0], si)
    np.testing.assert_allclose(s[0], ss, rtol=1e-6)
