"""The port's corpus-sharded exact search against the JAX package's, on the
CPU: the counterparts of tests/test_sharded_search.py.

The same seeded numpy matrices through the JAX ``ShardedIndex`` on the
conftest's 8 forced host devices and through the port's on ``[cpu] * 8``:
the same ids, scores within 1e-6 relative and absolute (the two packages
sum each dot in their own order; the JAX tests' unnormalized rows reach
scores of 20), and the same ids as the port's own single-device route on
the same matrix. Its scores agree within the same tolerance, not bit for
bit: the CPU BLAS
picks its kernel, and with it the order of each dot's sum, by the row
count (a block has fewer rows than the whole matrix), and moves a score by
an ulp. On the card the blocks run the same kernel phases as the single
device, and chip_smoke.py reports the largest difference."""

import ml_dtypes
import numpy as np
import pytest
import torch

from evossearch_tpu.parallel import ShardedIndex as RefSharded
from evossearch_tpu.parallel import corpus_mesh as ref_mesh
from evossearch_tpu_torch.index import search
from evossearch_tpu_torch.index.search import exact_search_batch, pallas_search_batch
from evossearch_tpu_torch.index.store import IndexReader, IndexWriter, bf16_bits
from evossearch_tpu_torch.parallel import ShardedIndex, corpus_mesh
from evossearch_tpu_torch.parallel import sharded_search

SCORE_TOL = dict(rtol=1e-6, atol=1e-6)


def _mesh(n=8):
    return corpus_mesh(devices=["cpu"] * n)


def _unit(rng, n, d):
    m = rng.standard_normal((n, d)).astype(np.float32)
    return m / np.linalg.norm(m, axis=1, keepdims=True)


def _check(matrix, queries, k, n_dev=8, single=exact_search_batch):
    """Port sharded = JAX sharded = the port's single-device ``single``
    route: the same ids, scores within SCORE_TOL."""
    queries = np.atleast_2d(np.asarray(queries, np.float32))
    ref = RefSharded.from_matrix(matrix, mesh=ref_mesh(n_dev))
    rs, ri = ref.search_batch(queries, k)
    port = ShardedIndex.from_matrix(matrix, mesh=_mesh(n_dev))
    ps, pi = port.search_batch(queries, k)
    assert pi.dtype == np.int64 and ps.dtype == np.float32
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_allclose(ps, rs, **SCORE_TOL)
    one_s, one_i = single(torch.from_numpy(matrix), queries, k)
    np.testing.assert_array_equal(pi, one_i)
    np.testing.assert_allclose(ps, one_s, **SCORE_TOL)
    return ps, pi


def test_matches_single_device():
    rng = np.random.default_rng(0)
    matrix = _unit(rng, 1000, 64)
    _check(matrix, rng.standard_normal(64), 48)


def test_ragged_tail_shard():
    # 1003 rows over 8 blocks: 126 rows each, the last 121
    rng = np.random.default_rng(1)
    matrix = rng.standard_normal((1003, 32)).astype(np.float32)
    port = ShardedIndex.from_matrix(matrix, mesh=_mesh())
    assert port.rows == 126 and port.counts.tolist() == [126] * 7 + [121]
    assert [b.shape[0] for b in port.blocks] == port.counts.tolist()
    _check(matrix, rng.standard_normal(32), 20)


def test_ragged_three_blocks():
    """S = 3: 334 rows per block, the last 332."""
    rng = np.random.default_rng(11)
    matrix = _unit(rng, 1000, 32)
    port = ShardedIndex.from_matrix(matrix, mesh=_mesh(3))
    assert port.counts.tolist() == [334, 334, 332]
    _check(matrix, rng.standard_normal((4, 32)), 25, n_dev=3)


def test_adversarial_ties_bit_identical():
    # 256 identical rows: every score ties; the contract is the lowest ids
    matrix = np.tile(np.eye(8, dtype=np.float32)[0], (256, 1))
    sh = ShardedIndex.from_matrix(matrix, mesh=_mesh())
    scores, idx = sh.search(np.eye(8, dtype=np.float32)[0], 10)
    np.testing.assert_array_equal(idx, np.arange(10))
    np.testing.assert_array_equal(scores, np.ones(10, np.float32))
    _check(matrix, np.eye(8, dtype=np.float32)[0], 10)


def test_tiny_corpus_smaller_than_k_times_shards():
    rng = np.random.default_rng(2)
    matrix = rng.standard_normal((5, 16)).astype(np.float32)  # < 8 blocks
    port = ShardedIndex.from_matrix(matrix, mesh=_mesh())
    assert port.counts.tolist() == [1] * 5 + [0] * 3
    _check(matrix, rng.standard_normal(16), 5)


def test_k_clamped():
    rng = np.random.default_rng(3)
    matrix = rng.standard_normal((10, 16)).astype(np.float32)
    sh = ShardedIndex.from_matrix(matrix, mesh=_mesh())
    scores, idx = sh.search(rng.standard_normal(16).astype(np.float32), 48)
    assert len(scores) == 10 and sorted(idx.tolist()) == list(range(10))


def test_negative_scores_not_beaten_by_padding():
    # all-negative scores: zero pad rows would win if they existed
    rng = np.random.default_rng(4)
    matrix = -np.abs(rng.standard_normal((37, 16))).astype(np.float32)
    query = np.abs(rng.standard_normal(16)).astype(np.float32)
    scores, idx = _check(matrix, query, 10)
    assert (idx < 37).all() and (scores < 0).all()


def test_batched_queries_match_single():
    rng = np.random.default_rng(6)
    matrix = rng.standard_normal((777, 32)).astype(np.float32)
    queries = rng.standard_normal((5, 32)).astype(np.float32)
    bs, bi = _check(matrix, queries, 12)
    sh = ShardedIndex.from_matrix(matrix, mesh=_mesh())
    for row in range(5):
        s1, i1 = sh.search(queries[row], 12)
        np.testing.assert_array_equal(bi[row], i1)
        np.testing.assert_allclose(bs[row], s1, **SCORE_TOL)


def test_bfloat16_corpus():
    """bf16 rows (the port's uint16 bits, the JAX package's ml_dtypes)."""
    rng = np.random.default_rng(5)
    matrix = _unit(rng, 500, 32)
    query = matrix[123]
    port = ShardedIndex.from_matrix(bf16_bits(matrix), mesh=_mesh())
    assert port.blocks[0].dtype == torch.bfloat16
    ps, pi = port.search(query, 5)
    assert pi[0] == 123
    ref = RefSharded.from_matrix(matrix.astype(ml_dtypes.bfloat16), mesh=ref_mesh(8))
    rs, ri = ref.search(query, 5)
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_allclose(ps, rs, **SCORE_TOL)
    one_s, one_i = exact_search_batch(
        torch.from_numpy(bf16_bits(matrix)).view(torch.bfloat16), query[None], 5)
    np.testing.assert_array_equal(pi, one_i[0])
    np.testing.assert_allclose(ps, one_s[0], **SCORE_TOL)


def test_merge_ranks_score_then_global_id():
    """The merge orders (score desc, global id asc) whatever the blocks'
    order, and its ties across blocks go to the lower id."""
    cand_s = np.array([[0.5, 0.9, 0.9, -np.inf, 0.5, 0.9]], np.float32)
    cand_i = np.array([[7, 40, 3, 1, 2, 12]], np.int64)
    s, i = sharded_search.merge_candidates(cand_s, cand_i, 5)
    np.testing.assert_array_equal(i, [[3, 12, 40, 2, 7]])
    np.testing.assert_array_equal(s, np.float32([[0.9, 0.9, 0.9, 0.5, 0.5]]))


class TestCertifiedShardedPath:
    """Blocks of CERT_MIN_SHARD_ROWS rows and up take the candidate
    kernels (their plain versions here) with their per-query fallback;
    the threshold is lowered so the CPU corpora reach them."""

    @pytest.fixture(autouse=True)
    def _low_threshold(self, monkeypatch):
        from evossearch_tpu.parallel import sharded_search as ref_ss

        monkeypatch.setattr(ref_ss, "CERT_MIN_SHARD_ROWS", 8)
        monkeypatch.setattr(sharded_search, "CERT_MIN_SHARD_ROWS", 8)

    def test_matches_single_device_batched(self):
        # the JAX cases (d % 128 or < 512 rows per block: the dense path),
        # and d = 128 blocks of 1024 rows (the block kernel, whose 12
        # candidates per 2048-row tile cannot certify k = 48: every query
        # takes the fallback)
        rng = np.random.default_rng(7)
        for n, d, q, k in ((4096, 64, 5, 48), (1003, 32, 3, 20),
                           (999, 128, 1, 64), (8192, 128, 3, 48)):
            matrix = _unit(rng, n, d)
            queries = rng.standard_normal((q, d)).astype(np.float32)
            _check(matrix, queries, k, single=pallas_search_batch)
            sh = ShardedIndex.from_matrix(matrix, mesh=_mesh())
            before = dict(search.DISPATCH_COUNTS)
            sh.search_batch(queries, k)
            kernel_blocks = 8 if (d % 128 == 0 and n // 8 >= 512) else 0
            assert search.DISPATCH_COUNTS["kernel"] - before["kernel"] == kernel_blocks
            assert search.DISPATCH_COUNTS["fallback"] - before["fallback"] == kernel_blocks

    def test_adversarial_ties_fall_back_and_stay_exact(self):
        # mass ties defeat the certificate: each block's fallback fires and
        # the tie contract still holds across blocks
        matrix = np.tile(np.eye(128, dtype=np.float32)[0], (8192, 1))
        queries = np.tile(np.eye(128, dtype=np.float32)[0], (3, 1))
        before = search.DISPATCH_COUNTS["fallback"]
        sh = ShardedIndex.from_matrix(matrix, mesh=_mesh())
        scores, idx = sh.search_batch(queries, 10)
        assert search.DISPATCH_COUNTS["fallback"] - before == 8
        for row in range(3):
            np.testing.assert_array_equal(idx[row], np.arange(10))
            np.testing.assert_array_equal(scores[row], np.ones(10, np.float32))

    def test_certified_used_and_certifies_on_random_data(self):
        # tie-free data: every block's certificate holds, no fallback
        rng = np.random.default_rng(9)
        matrix = _unit(rng, 8 * 16384, 128)
        queries = rng.standard_normal((4, 128)).astype(np.float32)
        before = dict(search.DISPATCH_COUNTS)
        sh = ShardedIndex.from_matrix(matrix, mesh=_mesh())
        ds, di = sh.search_batch(queries, 16)
        assert search.DISPATCH_COUNTS["kernel"] - before["kernel"] == 8
        assert search.DISPATCH_COUNTS["fallback"] == before["fallback"]
        es, ei = exact_search_batch(torch.from_numpy(matrix), queries, 16)
        np.testing.assert_array_equal(di, ei)
        np.testing.assert_allclose(ds, es, **SCORE_TOL)
        rs, ri = RefSharded.from_matrix(matrix, mesh=ref_mesh(8)).search_batch(queries, 16)
        np.testing.assert_array_equal(di, ri)


def test_from_reader_equals_from_matrix(tmp_path):
    """Block placement straight off the store's mmap (two shard files, a
    block across their border, a ragged last block) gives the results of
    from_matrix, which equal the JAX package's over the same store."""
    from evossearch_tpu.index.store import IndexReader as RefReader

    rng = np.random.default_rng(17)
    n, d = 1003, 128
    emb = _unit(rng, n, d)
    w = IndexWriter.create(tmp_path, model="t", dim=d, dtype_name="float32",
                           rows_per_shard=600)
    paths = [f"p{i}.jpg" for i in range(n)]
    meta = [{"path": p, "mtime": 1.0, "size": 1} for p in paths]
    w.append(emb, paths, meta)
    w.finalize()
    reader = IndexReader.open(tmp_path)
    assert len(reader.shard_arrays()) == 2
    queries = rng.standard_normal((4, d)).astype(np.float32)

    a = ShardedIndex.from_reader(reader, mesh=_mesh())
    b = ShardedIndex.from_matrix(emb, mesh=_mesh())
    for x, y in zip(a.blocks, b.blocks):
        assert torch.equal(x, y)
    sa, ia = a.search_batch(queries, 15)
    sb, ib = b.search_batch(queries, 15)
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_array_equal(sa, sb)
    rs, ri = RefSharded.from_reader(RefReader.open(tmp_path), n_devices=8).search_batch(
        queries, 15)
    np.testing.assert_array_equal(ia, ri)
    np.testing.assert_allclose(sa, rs, **SCORE_TOL)


def test_from_reader_bf16_store(tmp_path):
    rng = np.random.default_rng(18)
    emb = _unit(rng, 700, 32)
    w = IndexWriter.create(tmp_path, model="t", dim=32, dtype_name="bfloat16",
                           rows_per_shard=256)
    paths = [f"p{i}.jpg" for i in range(700)]
    w.append(emb, paths, [{"path": p, "mtime": 1.0, "size": 1} for p in paths])
    w.finalize()
    reader = IndexReader.open(tmp_path)
    assert len(reader.shard_arrays()) == 3
    a = ShardedIndex.from_reader(reader, mesh=_mesh(3))
    b = ShardedIndex.from_matrix(bf16_bits(emb), mesh=_mesh(3))
    for x, y in zip(a.blocks, b.blocks):
        assert x.dtype == torch.bfloat16 and torch.equal(x, y)


def test_default_mesh_needs_a_gpu_or_devices():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default mesh is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        corpus_mesh()
    assert corpus_mesh(3, ["cpu"] * 8).size == 3
    assert corpus_mesh(16, ["cpu"] * 2).size == 2
