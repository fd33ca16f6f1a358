"""The port against tests/test_certified_topk.py: the certified dense
path's exactness against the oracle, certification catching adversarial
tie floods, fallback correctness.

The JAX file lowers ``_FAST_PATH_MIN_ROWS`` so that its certified
ApproxTopK path runs at test sizes. The port has no ``approx_max_k``
(``ROADMAP.md`` C): its certified dense path is ``ops/topk.py:
stable_topk``, a ``torch.topk`` fetch of k + pad, a per-row certificate
and a full-sort redo of the uncertified rows. The counterpart fixture
lowers ``_SORT_MAX_SCORES`` and ``_FETCH_MIN_RATIO`` so that the fetch
and its certificate run at these sizes, and ``_certified_topk``'s ``ok``
flag is read as "no row was redone" (the redo is ``_sorted_topk`` on the
failed rows)."""

import numpy as np
import pytest
import torch

from evossearch_tpu_torch.index.search import exact_search, exact_search_batch
from evossearch_tpu_torch.ops import topk


@pytest.fixture(autouse=True)
def low_threshold(monkeypatch):
    monkeypatch.setattr(topk, "_SORT_MAX_SCORES", 0)
    monkeypatch.setattr(topk, "_FETCH_MIN_RATIO", 1)


def _oracle(emb, q, k):
    scores = emb.astype(np.float64) @ q.astype(np.float64)
    order = np.lexsort((np.arange(len(scores)), -scores))
    return order[:k]


def test_fast_path_matches_oracle():
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((5000, 64)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    q = rng.standard_normal(64).astype(np.float32)
    _, idx = exact_search(torch.from_numpy(emb), q, 48)
    np.testing.assert_array_equal(idx, _oracle(emb, q, 48))


def test_fast_path_batch_matches_oracle():
    rng = np.random.default_rng(1)
    emb = rng.standard_normal((4000, 32)).astype(np.float32)
    queries = rng.standard_normal((6, 32)).astype(np.float32)
    s, i = exact_search_batch(torch.from_numpy(emb), queries, 20)
    for row in range(6):
        np.testing.assert_array_equal(i[row], _oracle(emb, queries[row], 20))


def test_tie_flood_stays_exact():
    """More identical max-score rows than the overfetch budget: the
    certification must detect it and the redo must still deliver the
    lowest-index contract."""
    emb = np.tile(np.eye(8, dtype=np.float32)[0], (2048, 1))
    q = np.eye(8, dtype=np.float32)[0]
    _, idx = exact_search(torch.from_numpy(emb), q, 48)
    np.testing.assert_array_equal(idx, np.arange(48))


def test_certification_flag_logic(monkeypatch):
    """Directly exercise the certificate: unique scores certify ok (no
    row is redone)."""
    redone = []
    inner = topk._sorted_topk

    def counted(scores, k):
        redone.append(scores.shape)
        return inner(scores, k)

    monkeypatch.setattr(topk, "_sorted_topk", counted)
    rng = np.random.default_rng(2)
    scores = torch.from_numpy(rng.permutation(4096).astype(np.float32)[None, :])
    s, i = topk.stable_topk(scores, 10)
    assert redone == []  # ok
    np.testing.assert_array_equal(
        s.numpy()[0], np.arange(4095, 4085, -1, dtype=np.float32)
    )
