"""The port's top-k candidate kernels (their plain versions here on the
CPU) against the JAX package's Pallas kernels in interpret mode, cell for
cell on inputs whose dot products are exact in float32, plus the merge,
certificates, tie contract and routing. The CUDA kernels are held against
the plain versions in tests/test_torch_gpu.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evossearch_tpu.index import search as ref_search
from evossearch_tpu.ops import topk_pallas as ref
from evossearch_tpu_torch.index import search
from evossearch_tpu_torch.ops import topk

N, D, Q = 5000, 128, 5  # ragged tail: 5000 is no multiple of 256 or 512
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _exact_inputs(seed, n=N, d=D, q=Q, span=8):
    """Small integers over 16: exact dots in any order, real ties."""
    rng = np.random.default_rng(seed)
    emb = (rng.integers(-span, span + 1, (n, d)) / 16).astype(np.float32)
    queries = (rng.integers(-span, span + 1, (q, d)) / 16).astype(np.float32)
    return emb, queries


def _padded(queries):
    return jnp.asarray(np.concatenate(
        [queries, np.zeros((ref.LANES - len(queries), queries.shape[1]), np.float32)]
    ))


def _oracle(emb, queries, k):
    scores = queries @ emb.T
    order = np.stack([np.lexsort((np.arange(len(s)), -s))[:k] for s in scores])
    return np.take_along_axis(scores, order, 1), order


@pytest.mark.parametrize("levels", [3, 4])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_block_candidates_equal_pallas(dtype, levels):
    tdt, jdt = DTYPES[dtype]
    emb, queries = _exact_inputs(levels)
    ss, ii, cert = ref._block_candidates(
        jnp.asarray(emb, jdt), _padded(queries), interpret=True, levels=levels)
    scores, rows = topk.block_candidates(
        torch.from_numpy(emb).to(tdt), torch.from_numpy(queries), levels)
    assert scores.shape == (levels, len(np.asarray(cert)), Q)
    for lvl in range(levels - 1):
        np.testing.assert_array_equal(scores[lvl].numpy(), np.asarray(ss[lvl])[:, :Q])
        np.testing.assert_array_equal(rows[lvl].numpy(), np.asarray(ii[lvl])[:, :Q])
    np.testing.assert_array_equal(scores[levels - 1].numpy(), np.asarray(cert)[:, :Q])


@pytest.mark.parametrize("tile_rows", [512, 1024])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_tree_candidates_equal_pallas(dtype, tile_rows):
    tdt, jdt = DTYPES[dtype]
    emb, queries = _exact_inputs(tile_rows)
    cs, ci, m3 = ref._tree_candidates(
        jnp.asarray(emb, jdt), _padded(queries), tile_rows, interpret=True)
    got = topk.tree_candidates(
        torch.from_numpy(emb).to(tdt), torch.from_numpy(queries), tile_rows)
    for a, b in zip(got, (cs, ci, m3)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b)[:Q])


def test_tree_rank_order_is_the_halving_tree():
    # groups of one class, in the order the reference's tree prefers them
    # on ties: for 8 groups, pairs (g, g+4), then balanced merges
    assert topk.tree_rank_order(8) == [0, 4, 2, 6, 1, 5, 3, 7]
    assert topk.tree_rank_order(2) == [0, 1]
    with pytest.raises(ValueError):
        topk.tree_rank_order(6)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_block_final_results_equal_pallas(dtype):
    tdt, jdt = DTYPES[dtype]
    emb, queries = _exact_inputs(21, span=64)
    k = 10
    ok_r, s_r, i_r = (np.asarray(a) for a in ref.fused_topk_batch(
        jnp.asarray(emb, jdt), jnp.asarray(queries), k, interpret=True))
    ok, s, i = topk.fused_topk_batch(
        torch.from_numpy(emb).to(tdt), torch.from_numpy(queries), k)
    np.testing.assert_array_equal(ok.numpy(), ok_r)
    assert ok_r.any()
    np.testing.assert_array_equal(s.numpy()[ok_r], s_r[ok_r])
    np.testing.assert_array_equal(i.numpy()[ok_r], i_r[ok_r])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_tree_final_results_equal_pallas(dtype):
    tdt, jdt = DTYPES[dtype]
    emb, queries = _exact_inputs(22, span=64)
    k = 4
    ok_r, s_r, i_r = (np.asarray(a) for a in ref.fused_topk_batch_tree(
        jnp.asarray(emb, jdt), jnp.asarray(queries), k, interpret=True))
    ok, s, i = topk.fused_topk_batch_tree(
        torch.from_numpy(emb).to(tdt), torch.from_numpy(queries), k)
    ok = ok.numpy()
    both = ok & ok_r
    assert both.any()
    np.testing.assert_array_equal(s.numpy()[both], s_r[both])
    np.testing.assert_array_equal(i.numpy()[both], i_r[both])
    # certified rows are the exact top-k
    os_, oi_ = _oracle(emb, queries if dtype == "f32" else queries, k)
    np.testing.assert_array_equal(i.numpy()[ok], oi_[ok])


@pytest.mark.parametrize("kernel", ["block", "tree"])
def test_all_ties_fail_certification(kernel):
    emb = torch.ones((3000, 128))
    queries = torch.ones((4, 128))
    fn = topk.fused_topk_batch if kernel == "block" else topk.fused_topk_batch_tree
    ok, _, _ = fn(emb, queries, 48)
    assert not ok.any()
    # the search wrapper still returns the exact rows, lowest index first
    s, i = search.pallas_search_batch(emb, queries, 10)
    np.testing.assert_array_equal(i, np.tile(np.arange(10), (4, 1)))


@pytest.mark.parametrize("kernel", ["block", "tree"])
def test_duplicate_rows_keep_lowest_index(kernel):
    rng = np.random.default_rng(7)
    emb = rng.standard_normal((4000, 128)).astype(np.float32)
    emb[3100] = emb[40]
    emb[900] = emb[40]
    queries = emb[[40, 7]].copy()
    fn = topk.fused_topk_batch if kernel == "block" else topk.fused_topk_batch_tree
    ok, s, i = fn(torch.from_numpy(emb), torch.from_numpy(queries), 6)
    assert ok[0]
    assert i[0, :3].tolist() == [40, 900, 3100]
    _, oi_ = _oracle(emb, queries, 6)
    np.testing.assert_array_equal(i.numpy()[ok.numpy()], oi_[ok.numpy()])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_pallas_search_batch_matches_reference(dtype):
    tdt, jdt = DTYPES[dtype]
    emb, queries = _exact_inputs(31)  # heavy ties: fallback rows too
    s_r, i_r = ref_search.pallas_search_batch(
        jnp.asarray(emb, jdt), queries, 12)
    s, i = search.pallas_search_batch(
        torch.from_numpy(emb).to(tdt), queries, 12)
    np.testing.assert_array_equal(i, np.asarray(i_r))
    np.testing.assert_array_equal(s, np.asarray(s_r))


def test_dense_path_matches_reference():
    emb, queries = _exact_inputs(41)
    for dtype in sorted(DTYPES):
        tdt, jdt = DTYPES[dtype]
        s_r, i_r = ref_search.exact_search_batch(jnp.asarray(emb, jdt), queries, 7)
        s, i = search.exact_search_batch(torch.from_numpy(emb).to(tdt), queries, 7)
        np.testing.assert_array_equal(i, np.asarray(i_r))
        np.testing.assert_array_equal(s, np.asarray(s_r))


def test_bf16_dense_scores_stay_float32():
    # a bf16 x bf16 product would round the scores to bf16 and invent ties
    rng = np.random.default_rng(2)
    emb = torch.from_numpy(rng.standard_normal((300, 128)).astype(np.float32))
    emb = emb.to(torch.bfloat16)
    q = torch.from_numpy(rng.standard_normal((2, 128)).astype(np.float32))
    s = topk.dense_scores(emb, q)
    assert s.dtype == torch.float32
    want = q.bfloat16().double() @ emb.double().T
    np.testing.assert_allclose(s.numpy(), want.numpy(), rtol=1e-6, atol=1e-5)


ROUTE_GRID = [
    (n, k, dtype)
    for n in (100, 511, 512, 5000, (1 << 18) - 1, 1 << 18, 300_000, 532_000,
              540_000, 1 << 20, 10_000_000, 1 << 24)
    for k in (1, 12, 48, 128, 129)
    for dtype in sorted(DTYPES)
]


def test_routing_matches_reference():
    for n, k, dtype in ROUTE_GRID:
        tdt, jdt = DTYPES[dtype]
        assert topk.use_tree_kernel(n, k, tdt) == ref.use_tree_kernel(n, k, jdt)
        for kernel in ("best", "pallas", "xla"):
            want, _ = ref_search.choose_packed_flavor(n, 512, k, jdt, kernel)
            want = "exact" if want == "certified" else want
            got = search.choose_packed_flavor(n, 512, k, tdt, kernel, on_cpu=True)
            assert got == want, (n, k, dtype, kernel)
        # on the card, "best" routes as the reference does on an accelerator:
        # the kernels from 2^18 rows, within the kernels' shape contract
        want, _ = ref_search.choose_packed_flavor(n, 512, k, jdt, "pallas")
        if want == "certified" or n < search._FAST_PATH_MIN_ROWS:
            want = "exact"
        assert search.choose_packed_flavor(n, 512, k, tdt, "best", on_cpu=False) == want


def test_query_row_bucket_matches_reference():
    for q in range(1, 600):
        assert search.query_row_bucket(q) == ref_search.query_row_bucket(q)


def test_wrappers_check_inputs_and_count_only_kernel_launches():
    emb = torch.zeros((1000, 128))
    before = dict(topk.LAUNCHES)
    topk.block_candidates(emb, torch.zeros((2, 128)))
    topk.tree_candidates(emb, torch.zeros((2, 128)), 512)
    assert topk.LAUNCHES == before  # plain runs on the CPU are not launches
    with pytest.raises(ValueError):
        topk.block_candidates(torch.zeros((1000, 100)), torch.zeros((2, 100)))
    with pytest.raises(ValueError):
        topk.block_candidates(emb, torch.zeros((129, 128)))
    with pytest.raises(ValueError):
        topk.tree_candidates(emb.T.contiguous().T, torch.zeros((2, 128)), 512)
    with pytest.raises(ValueError):
        topk.block_candidates(emb.half(), torch.zeros((2, 128)))
    with pytest.raises(ValueError):
        topk.tree_candidates(emb, torch.zeros((2, 128)), 768)
    with pytest.raises(ValueError):
        topk.fused_topk_batch(emb, torch.zeros((2, 128)), 129)
