"""The port against tests/test_property_topk.py: Hypothesis property
tests of the exact-recall guarantee of every search path against a
float64 oracle, over adversarial generated inputs (duplicates, ties,
tiny/degenerate shapes, extreme values).

Harness only: the device search takes a torch corpus, and the tree
kernel is ``ops.topk.fused_topk_batch_tree`` on CPU tensors (its plain
version; the JAX file runs the Pallas kernel in interpret mode)."""

import numpy as np
import torch
from hypothesis import given, settings, strategies as st

from evossearch_tpu_torch.index import exact_search
from evossearch_tpu_torch.index.search import exact_search_host


def _scores64(emb, q):
    """f64 oracle scores via per-row np.dot: a single BLAS matmul gives
    BIT-IDENTICAL duplicate rows f64 results differing by 1 ULP when one
    row lands in the kernel's tail block (observed at n=375: rows 314 and
    372 equal, dots differ by 3.6e-15), which silently flips the oracle's
    tie order. Per-row dot sees identical inputs -> identical outputs."""
    q64 = q.astype(np.float64)
    emb64 = emb.astype(np.float64)
    return np.array([np.dot(row, q64) for row in emb64])


def _oracle(emb, q, k):
    scores = _scores64(emb, q)
    order = np.lexsort((np.arange(len(scores)), -scores))
    return order[:k]


@st.composite
def corpus_and_query(draw):
    n = draw(st.integers(1, 400))
    d = draw(st.sampled_from([4, 16, 64]))
    seed = draw(st.integers(0, 2**31 - 1))
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((n, d)).astype(np.float32)
    # inject duplicates / ties with some probability
    if draw(st.booleans()) and n > 4:
        src = rng.integers(0, n, size=n // 3)
        dst = rng.integers(0, n, size=n // 3)
        emb[dst] = emb[src]
    if draw(st.booleans()):
        emb[: n // 2] = 0.0  # zero rows -> massive score ties
    q = rng.standard_normal(d).astype(np.float32)
    k = draw(st.integers(1, min(64, n)))
    return emb, q, k


def _check(emb, q, k, idx, scores):
    """Exactness modulo f32 arithmetic: the implementation computes scores
    in float32, the oracle in float64 — indices may legitimately differ
    where f64 scores are within f32 noise of each other. Assertions:
      * returned scores are sorted descending;
      * the returned set's f64 scores match the oracle top-k's f64 scores
        to f32 tolerance (no genuinely-better row was missed);
      * indices match the oracle exactly wherever the oracle's ranking has
        a margin above f32 noise. (The lowest-index tie contract on EXACT
        ties is pinned separately by the adversarial-tie tests in
        test_search.py / test_topk_pallas.py / test_sharded_search.py.)
    """
    s64 = _scores64(emb, q)
    full_order = np.lexsort((np.arange(len(s64)), -s64))
    oracle = full_order[:k]
    idx = np.asarray(idx)
    assert (np.diff(scores) <= 1e-6).all()
    np.testing.assert_allclose(s64[idx], s64[oracle], atol=1e-4)
    tol = 1e-4 * max(1.0, np.abs(s64).max())
    for rank in range(k):
        prev_gap = s64[oracle[rank - 1]] - s64[oracle[rank]] if rank else np.inf
        # boundary rank: the gap below is to the FULL ranking's next
        # element (rank k of full_order), not inf — a tie straddling the
        # top-k boundary makes the k-th index legitimately ambiguous
        next_gap = (
            s64[full_order[rank]] - s64[full_order[rank + 1]]
            if rank + 1 < len(full_order) else np.inf
        )
        if prev_gap > tol and next_gap > tol:
            assert idx[rank] == oracle[rank], (rank, idx, oracle)


@settings(max_examples=40, deadline=None)
@given(corpus_and_query())
def test_device_exact_search_matches_oracle(data):
    emb, q, k = data
    scores, idx = exact_search(torch.from_numpy(emb), q, k)
    _check(emb, q, k, idx, scores)


@settings(max_examples=25, deadline=None)
@given(corpus_and_query())
def test_host_scan_matches_oracle(data):
    emb, q, k = data
    scores, idx = exact_search_host(emb, q, k)
    _check(emb, q, k, idx, scores)


@st.composite
def tree_corpus(draw):
    """Corpora sized for the tree kernel (d % 128 == 0), with planted
    exact ties — the score-only in-kernel merges (round 2) must never
    CERTIFY a wrong answer; uncertified rows are allowed and routed to
    the exact fallback by callers."""
    n = draw(st.integers(600, 4000))
    seed = draw(st.integers(0, 2**31 - 1))
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((n, 128)).astype(np.float32)
    if draw(st.booleans()):
        src = rng.integers(0, n, size=max(1, n // 4))
        dst = rng.integers(0, n, size=max(1, n // 4))
        emb[dst] = emb[src]  # exact duplicate rows -> exact score ties
    q = draw(st.integers(1, 4))
    queries = rng.standard_normal((q, 128)).astype(np.float32)
    if draw(st.booleans()):
        queries[0] = emb[rng.integers(0, n)]  # self-query: top score tie-prone
    k = draw(st.integers(1, 16))
    return emb, queries, k


@settings(max_examples=12, deadline=None)
@given(tree_corpus())
def test_tree_kernel_certified_rows_never_wrong(data):
    from evossearch_tpu_torch.ops.topk import fused_topk_batch_tree

    emb, queries, k = data
    ok, s, i = fused_topk_batch_tree(
        torch.from_numpy(emb), torch.from_numpy(queries), k
    )
    ok, s, i = ok.numpy(), s.numpy(), i.numpy()
    s64 = emb.astype(np.float64)
    for row in range(queries.shape[0]):
        if not ok[row]:
            continue  # uncertified -> callers run the exact fallback
        scores = s64 @ queries[row].astype(np.float64)
        oracle = np.lexsort((np.arange(len(scores)), -scores))[:k]
        # certified rows must honor the contract: where the kernel's
        # answer differs from the f64 oracle, it may only be f32
        # arithmetic noise — the f64 scores of the returned set must
        # match the oracle's to f32 tolerance (nothing genuinely better
        # was missed), and EXACT f64 ties must surface lowest-index
        # first among equal-score prefixes.
        if not np.array_equal(i[row], oracle):
            np.testing.assert_allclose(
                scores[i[row]], scores[oracle], atol=1e-4
            )
        # exact-tie index order on the kernel's own reported scores
        rep = s[row]
        for a in range(k - 1):
            if rep[a] == rep[a + 1]:
                assert i[row][a] < i[row][a + 1], (i[row], rep)
