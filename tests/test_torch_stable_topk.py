"""``ops.topk.stable_topk``, the dense path's exact selection: a fetch of
the top k + pad through ``torch.topk``, ordered by (score desc, position
asc), certified per row, with the rows whose tie plateau is wider than
the pad redone by a full sort. It must give the same values and positions
as a stable descending sort on every input, for every caller's shape."""

import numpy as np
import pytest
import torch

from evossearch_tpu_torch.ops import topk

PAD = topk._TREE_FETCH_PAD
NEG = topk.NEG_INF
SORT_MAX_SCORES, FETCH_MIN_RATIO = topk._SORT_MAX_SCORES, topk._FETCH_MIN_RATIO


def _sorted(scores: torch.Tensor, k: int):
    """The oracle, written here: a stable descending sort of whole rows."""
    vals, pos = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], pos[..., :k]


def _check(scores: torch.Tensor, k: int):
    got_v, got_p = topk.stable_topk(scores, k)
    want_v, want_p = _sorted(scores, k)
    assert got_v.shape == want_v.shape and got_p.dtype == torch.int64
    assert torch.equal(got_v, want_v)
    assert torch.equal(got_p, want_p)


@pytest.fixture(autouse=True)
def fetch_path(monkeypatch):
    """The inputs here are small: the crossover is lowered so that the
    fetch path runs on any row longer than the fetch (the test of the
    default branch restores it)."""
    monkeypatch.setattr(topk, "_SORT_MAX_SCORES", 0)
    monkeypatch.setattr(topk, "_FETCH_MIN_RATIO", 1)


@pytest.fixture
def redo_count(monkeypatch):
    """Counts the full sorts of the certified path's redo (calls of
    ``_sorted_topk`` on fewer rows than the input)."""
    calls = []
    inner = topk._sorted_topk

    def counted(scores, k):
        calls.append(scores.shape)
        return inner(scores, k)

    monkeypatch.setattr(topk, "_sorted_topk", counted)
    return calls


@pytest.mark.parametrize("k", [1, 48, 128])
@pytest.mark.parametrize("n", [200, 5000])
def test_random_scores(n, k):
    rng = np.random.default_rng(n + k)
    scores = torch.from_numpy(rng.standard_normal((7, n)).astype(np.float32))
    _check(scores, k)


@pytest.mark.parametrize("k", [1, 48, 128])
def test_ties_straddle_the_kth_place(k, redo_count):
    """Scores rounded to 1/8: every row holds long runs of equal scores,
    and the k-th place falls inside one."""
    rng = np.random.default_rng(k)
    scores = torch.from_numpy(
        (np.round(rng.standard_normal((16, 4000)) * 8) / 8).astype(np.float32))
    _check(scores, k)
    v, _ = _sorted(scores, k + 1)
    assert (v[:, k - 1] == v[:, k]).any()  # some row ties across the cut


def test_all_equal_rows_take_the_redo(redo_count):
    scores = torch.full((5, 1000), 0.25)
    _check(scores, 48)
    assert redo_count == [(5, 1000)]  # every row's plateau is wider than the pad


def test_plateau_wider_than_the_pad_is_redone_on_its_rows_only(redo_count):
    rng = np.random.default_rng(2)
    scores = torch.from_numpy(rng.standard_normal((6, 3000)).astype(np.float32))
    k = 10
    # rows 1 and 4: the top 5 scores, then a plateau of 2 * PAD equal
    # scores spread over the row, so the k-th score sits inside it
    for r in (1, 4):
        cols = torch.from_numpy(rng.choice(3000, 2 * PAD + 5, replace=False))
        scores[r, cols[:5]] = 10.0 + torch.arange(5.0)
        scores[r, cols[5:]] = 5.0
    _check(scores, k)
    assert redo_count == [(2, 3000)]


def test_plateau_inside_the_pad_needs_no_redo(redo_count):
    scores = torch.linspace(1.0, -1.0, 2000).repeat(3, 1)
    scores[:, 500:520] = 2.0  # 20 ties at the top, all inside k + pad
    _check(scores, 30)
    assert redo_count == []


def test_neg_inf_padding():
    """Rows padded with NEG_INF past their real scores, as the plain
    candidate versions pad partial tiles; k past the real count."""
    rng = np.random.default_rng(3)
    scores = torch.full((4, 600), NEG)
    scores[:, :70] = torch.from_numpy(rng.standard_normal((4, 70)).astype(np.float32))
    for k in (48, 100, 128):
        _check(scores, k)


@pytest.mark.parametrize("n", [1, 20, 48 + PAD, 48 + PAD + 1])
def test_k_equal_to_the_row_length_and_short_rows(n):
    rng = np.random.default_rng(n)
    scores = torch.from_numpy(np.round(rng.standard_normal((3, n)) * 4).astype(np.float32))
    for k in {1, min(48, n), n}:
        _check(scores, k)


def test_small_inputs_and_short_rows_keep_the_full_sort(redo_count, monkeypatch):
    """Up to _SORT_MAX_SCORES scores, or on rows shorter than
    _FETCH_MIN_RATIO fetches, the full sort runs, once, on the whole
    input; one row more of long rows takes the fetch."""
    monkeypatch.setattr(topk, "_SORT_MAX_SCORES", SORT_MAX_SCORES)
    monkeypatch.setattr(topk, "_FETCH_MIN_RATIO", FETCH_MIN_RATIO)
    n = FETCH_MIN_RATIO * (48 + PAD)
    rows = topk._SORT_MAX_SCORES // n
    gen = torch.Generator().manual_seed(0)
    scores = torch.randn(rows, n, generator=gen)
    _check(scores, 48)
    assert redo_count == [scores.shape]
    _check(torch.cat([scores, scores[:1]]), 48)
    assert redo_count == [scores.shape]
    short = torch.randn(SORT_MAX_SCORES // 256 + 1, 256, generator=gen)
    _check(short, 4)  # the block plain version's rows
    assert redo_count == [scores.shape, short.shape]


def test_three_and_four_dim_and_transposed_inputs():
    """The shapes the plain candidate versions pass: (Q, blocks, 256)
    views at k = levels, (Q, tiles, classes, groups) transposes at k = 3,
    and a transposed 2-D matrix."""
    rng = np.random.default_rng(4)
    s3 = torch.from_numpy(
        (rng.integers(-3, 4, (5, 12 * 256)) / 8).astype(np.float32)).view(5, 12, 256)
    for k in (3, 4):
        _check(s3, k)
    s4 = torch.from_numpy(
        (rng.integers(-3, 4, (2, 3, 64, 128)) / 8).astype(np.float32)).transpose(2, 3)
    assert not s4.is_contiguous()
    _check(s4, 3)
    s2 = torch.from_numpy(rng.standard_normal((3000, 9)).astype(np.float32)).T
    assert not s2.is_contiguous()
    _check(s2, 48)


def test_callers_get_the_sort_results():
    """The dense exact path (index.search) selects through stable_topk
    and stays equal to a stable sort of its scores."""
    from evossearch_tpu_torch.index import search

    rng = np.random.default_rng(5)
    emb = torch.from_numpy((rng.integers(-2, 3, (6000, 128)) / 16).astype(np.float32))
    q = torch.from_numpy((rng.integers(-2, 3, (9, 128)) / 16).astype(np.float32))
    got = search._topk_batch(emb, q, 48)
    want = _sorted(q @ emb.T, 48)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
