"""The port against tests/test_search.py: exact search, numpy-oracle
equivalence, tie determinism, FAISS-shape contract (reference
oldapp.py:2002-2005).

Harness only: corpora are torch tensors (bf16 through ``torch.bfloat16``
where the JAX file uses ``ml_dtypes``), and the JAX-internal names map to
the port's counterparts:
- ``_fast_topk_batch_packed`` (the certified dense route) and
  ``_pallas_topk_packed`` (the block kernel) are ``index/search.py:
  packed_topk`` with the flavors ``exact`` and ``block`` (on the CPU the
  block kernel's plain version);
- ``test_best_kernel_routes_small_corpora_to_xla`` pretends a TPU backend
  in the JAX package; the port routes by the corpus's device, so the
  accelerator's choice is asked of ``choose_packed_flavor(...,
  on_cpu=False)`` and the search itself runs with the kernel route
  patched to fail, as in the JAX file;
- ``sort_by_score_then_index`` is the port's function of that name
  (``ops/topk.py``), and the same orders are held for ``ops/topk.py:
  stable_topk``, the counterpart of ``blocked_top_k``, on the candidates
  laid out by index.
"""

import numpy as np
import torch

from evossearch_tpu_torch.index import exact_search, exact_search_batch


def _oracle(emb, q, k):
    scores = emb.astype(np.float64) @ q.astype(np.float64)
    order = np.lexsort((np.arange(len(scores)), -scores))  # score desc, idx asc
    return scores[order[:k]], order[:k]


def test_matches_numpy_oracle():
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((1000, 64)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    q = rng.standard_normal(64).astype(np.float32)
    q /= np.linalg.norm(q)
    scores, idx = exact_search(torch.from_numpy(emb), q, 48)
    o_scores, o_idx = _oracle(emb, q, 48)
    np.testing.assert_array_equal(idx, o_idx)
    np.testing.assert_allclose(scores, o_scores, atol=1e-5)


def test_adversarial_ties_deterministic():
    # Many duplicate rows -> equal scores; contract: lower index first.
    emb = np.tile(np.eye(4, dtype=np.float32)[0], (32, 1))
    q = np.eye(4, dtype=np.float32)[0]
    _, idx = exact_search(torch.from_numpy(emb), q, 10)
    np.testing.assert_array_equal(idx, np.arange(10))


def test_k_clamped_to_n():
    emb = np.eye(4, dtype=np.float32)
    q = emb[2]
    scores, idx = exact_search(torch.from_numpy(emb), q, 48)  # k > n
    assert len(scores) == 4
    assert idx[0] == 2


def test_empty_index():
    scores, idx = exact_search(torch.zeros((0, 8)), np.zeros(8, np.float32), 5)
    assert scores.shape == (0,) and idx.shape == (0,)


def test_batch_matches_single():
    rng = np.random.default_rng(1)
    emb = rng.standard_normal((500, 32)).astype(np.float32)
    queries = rng.standard_normal((4, 32)).astype(np.float32)
    b_scores, b_idx = exact_search_batch(torch.from_numpy(emb), queries, 12)
    for i in range(4):
        s, ix = exact_search(torch.from_numpy(emb), queries[i], 12)
        np.testing.assert_array_equal(b_idx[i], ix)
        np.testing.assert_allclose(b_scores[i], s, atol=1e-5)


def test_bfloat16_index_still_exact_ordering_on_separated_scores():
    rng = np.random.default_rng(2)
    emb = rng.standard_normal((300, 64)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    q = emb[17] + 0.0  # near-duplicate query: top-1 must be row 17
    _, idx = exact_search(torch.from_numpy(emb).to(torch.bfloat16), q, 5)
    assert idx[0] == 17


def test_packed_results_carry_indices_as_f32_values():
    # Regression: indices used to ride the packed result as int32->f32
    # BITCASTS, i.e. denormal bit patterns, which TPU compute flushes to
    # zero in some compilations (observed on hardware: correct scores,
    # all indices zero). They must ride as exact f32 VALUES instead.
    from evossearch_tpu_torch.index.search import packed_topk

    n, d, k = 600_000, 128, 4  # big enough for large index values
    emb = np.zeros((n, d), np.float32)
    hot = [3, 2**19 + 11, n - 2, 2**18]  # includes values > 2^17
    for rank, row in enumerate(hot):
        emb[row, 0] = 10.0 - rank
    queries = np.zeros((2, d), np.float32)
    queries[:, 0] = 1.0
    emb_t, queries_t = torch.from_numpy(emb), torch.from_numpy(queries)
    for flavor in ("exact", "block"):
        packed = packed_topk(emb_t, queries_t, k, flavor).numpy()
        idx = packed[:, k : 2 * k]
        # f32 VALUE encoding: fractional part zero, exact integers
        assert (idx == np.round(idx)).all()
        got = idx[0].astype(np.int64)
        ok = packed[0, -1] > 0
        if ok:
            assert list(got) == sorted(hot, key=lambda r: -emb[r, 0]), got


def test_fast_path_guard_above_pack_limit():
    from evossearch_tpu_torch.index import search as S

    # corpora >= 2^24 rows must not take the packed fast path (f32 values
    # can't carry those indices exactly); spot-check the guard constants.
    assert S._PACK_MAX_ROWS == 1 << 24


def test_best_kernel_routes_small_corpora_to_xla(monkeypatch):
    """Regression (round-2 review): on accelerators the auto policy must
    NOT send small corpora to the block kernel — its certificate fails
    for nearly every query below ~2^18 rows and each batch would pay
    kernel + exact fallback (two dispatches)."""
    import evossearch_tpu_torch.index.search as search_mod

    # the accelerator's choice for this corpus
    assert search_mod.choose_packed_flavor(
        4096, 128, 10, torch.float32, "best", on_cpu=False) == "exact"

    def boom(*a, **k):  # pragma: no cover - failure path
        raise AssertionError("pallas path selected for a small corpus")

    monkeypatch.setattr(search_mod, "pallas_search_batch", boom)
    rng = np.random.default_rng(0)
    emb = torch.from_numpy(rng.standard_normal((4096, 128)).astype(np.float32))
    qs = rng.standard_normal((4, 128)).astype(np.float32)
    s, i = search_mod.best_exact_search_batch(emb, qs, 10)
    es, ei = search_mod.exact_search_batch(emb, qs, 10)
    np.testing.assert_array_equal(i, ei)


def test_sort_by_score_then_index_equals_lexsort():
    """The batched two-key value sort of every device merge must order
    identically on adversarial inputs: exact ties, duplicate (s, i)
    pairs, NEG_INF padding, and k larger than the candidate width."""
    from evossearch_tpu_torch.ops.topk import (
        NEG_INF, sort_by_score_then_index, stable_topk,
    )

    rng = np.random.default_rng(3)
    q, c = 7, 33
    s = rng.choice([0.5, 0.25, -0.125, NEG_INF], size=(q, c)).astype(
        np.float32
    )
    i = rng.permutation(q * c).reshape(q, c).astype(np.int32)
    i[2, 5] = i[2, 9]  # duplicate index with equal score -> value-equal
    s[2, 5] = s[2, 9]
    # the same candidates laid out by index: stable_topk's position order
    by_i = np.argsort(i, axis=1, kind="stable")
    s_by_i = np.take_along_axis(s, by_i, 1)
    i_by_i = np.take_along_axis(i, by_i, 1)
    for k in (1, 5, c, c + 3):
        kk = min(k, c)
        ts, ti = sort_by_score_then_index(torch.from_numpy(s), torch.from_numpy(i), k)
        ts, ti = ts.numpy(), ti.numpy()
        assert ts.shape == (q, kk) and ti.shape == (q, kk)
        vs, pos = stable_topk(torch.from_numpy(s_by_i), kk)
        vs, vi = vs.numpy(), np.take_along_axis(i_by_i, pos.numpy(), 1)
        for row in range(q):
            order = np.lexsort((i[row], -s[row]))[:kk]
            np.testing.assert_array_equal(ts[row], s[row][order])
            np.testing.assert_array_equal(ti[row], i[row][order])
            np.testing.assert_array_equal(vs[row], s[row][order])
            np.testing.assert_array_equal(vi[row], i[row][order])
