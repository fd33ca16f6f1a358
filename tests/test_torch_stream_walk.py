"""The walk that B4's stream kernel (``ops/csrc/topk_stream.cu``) relies
on, on the CPU, where no kernel runs.

A persistent grid of ``blocks`` blocks; block b owns the contiguous tiles
[b*T/B, (b+1)*T/B) of ``tile_rows`` rows and walks them in order. A row
whose score beats the block's threshold t (its running k-th best, -inf
until k rows are in) is pushed into a candidate buffer; after a tile, the
buffer is merged into the running top-k when it could not take another
tile (or, while the list is not full, once k candidates wait), and t
rises. A final merge joins the blocks' k-lists pairwise, one warp per
pair along the merge path, and maps slots scoring NEG_INF or less to
(NEG_INF, -1). These tests hold a numpy model of that walk
against the plain version and the JAX package's Pallas ``fused_topk`` in
interpret mode, and pin the layout the wrapper gives the kernel. The
kernel itself is held against the plain version in tests/test_torch_gpu.py
and chip_smoke.py."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evossearch_tpu.ops import fused_topk as ref_fused_topk
from evossearch_tpu_torch.ops import topk

NEG = np.float32(topk.NEG_INF)
FREE = (-np.inf, 2**31 - 1)  # a free running slot
SRC = Path(topk.__file__).resolve().parent / "csrc" / "topk_stream.cu"


def _merge(run, cand, k):
    """The kernel's merge: the first k of the union under (score desc,
    row asc); every entry has its own row."""
    return sorted(run + cand, key=lambda p: (-p[0], p[1]))[:k]


def _walk(stream, k, step, buf):
    """The strict-threshold selection over ``stream`` (a list of (score,
    row) in walk order), ``step`` entries between merge checks, a buffer
    of ``buf``."""
    run, pending, limit = [FREE] * k, [], buf - step
    for s0 in range(0, len(stream), step):
        t = run[k - 1][0]
        pending += [p for p in stream[s0 : s0 + step] if p[0] > t]
        assert len(pending) <= buf
        if len(pending) > (min(k - 1, limit) if t == -np.inf else limit):
            run, pending = _merge(run, pending, k), []
    return _merge(run, pending, k) if pending else run


def _before(x, y):
    """x precedes y under (score desc, row asc)."""
    return x[0] > y[0] or (x[0] == y[0] and x[1] < y[1])


def _merge_pair(a, b, k):
    """The final kernel's merge of two k-lists, lane by lane of one warp:
    lane l takes output positions l*per .. (per = cdiv(k, 32)), finds on
    the merge path's diagonal how many of the outputs before them come
    from a, and merges its own in order; a goes first on equal entries."""
    per = -(-k // 32)
    out = [None] * k
    for lane in range(32):
        d0 = lane * per
        if d0 >= k:
            continue
        lo, hi = max(0, d0 - k), min(d0, k)
        while lo < hi:
            mid = (lo + hi) // 2
            if not _before(b[d0 - 1 - mid], a[mid]):
                lo = mid + 1
            else:
                hi = mid
        i, j = lo, d0 - lo
        for o in range(d0, min(d0 + per, k)):
            take_a = j >= k or (i < k and not _before(b[j], a[i]))
            out[o] = a[i] if take_a else b[j]
            i, j = i + take_a, j + (not take_a)
    assert out == sorted(a + b, key=lambda p: (-p[0], p[1]))[:k]
    return out


def _kernel_model(scores, k, tile_rows, blocks, buf=topk._STREAM_BUF):
    """(scores (k,), rows (k,)) as the kernel computes them from the
    rows' f32 scores."""
    n = len(scores)
    tiles = -(-n // tile_rows)
    lists = []
    for b in range(blocks):
        t0, t1 = b * tiles // blocks, (b + 1) * tiles // blocks
        rows = range(t0 * tile_rows, min(t1 * tile_rows, n))
        lists.append(_walk([(scores[r], r) for r in rows], k, tile_rows, buf))
    while len(lists) > 1:  # pairwise rounds; an odd last list is copied
        lists = [_merge_pair(*lists[j : j + 2], k) if j + 1 < len(lists) else lists[j]
                 for j in range(0, len(lists), 2)]
    out = lists[0] if lists else [FREE] * k
    s = np.array([p[0] if p[0] > NEG else NEG for p in out], np.float32)
    i = np.array([p[1] if p[0] > NEG else -1 for p in out], np.int64)
    return s, i


def _exact(n, seed, d=64):
    """Rows of integers in [-2, 2] over 16 and a query of four entries
    +-1/2 (norm exactly 1): every score is an exact multiple of 1/32, and
    equal scores tie for real."""
    rng = np.random.default_rng(seed)
    emb = (rng.integers(-2, 3, (n, d)) / 16).astype(np.float32)
    q = np.zeros(d, np.float32)
    q[rng.choice(d, 4, replace=False)] = rng.choice([-0.5, 0.5], 4)
    return emb, q


def _check(emb, q, k, tile_rows, blocks, **kw):
    """Model, plain version and Pallas interpret agree bit for bit."""
    scores = emb @ q  # exact: the kernel's dots, in any order
    got_s, got_i = _kernel_model(scores, k, tile_rows, blocks, **kw)
    plain_s, plain_i = topk.fused_topk_plain(torch.from_numpy(emb), torch.from_numpy(q), k)
    np.testing.assert_array_equal(got_s, plain_s.numpy())
    np.testing.assert_array_equal(got_i, plain_i.numpy())
    ref_s, ref_i = ref_fused_topk(jnp.asarray(emb), jnp.asarray(q), k,
                                  block_rows=256, interpret=True)
    np.testing.assert_array_equal(got_s, np.asarray(ref_s))
    np.testing.assert_array_equal(got_i, np.asarray(ref_i))
    return scores, got_s


@pytest.mark.parametrize("k", [1, 12, 48, 128])
@pytest.mark.parametrize("tile_rows,blocks", [(32, 7), (64, 3), (5, 40), (1, 9)])
def test_walk_equals_plain_and_pallas(tile_rows, blocks, k):
    emb, q = _exact(3001, k + blocks)
    scores, _ = _check(emb, q, k, tile_rows, blocks)
    best = np.sort(scores)[::-1]
    assert best[k] == best[k - 1]  # the inputs tie across the cut of the top k


@pytest.mark.parametrize("k", [12, 48])
def test_small_buffers_merge_often(k):
    """A buffer of a few tiles: many merges in each block, each exact."""
    emb, q = _exact(2500, 7)
    _check(emb, q, k, 4, 11, buf=k + 8 if k < 16 else 64)


@pytest.mark.parametrize("blocks", [2, 5, 16])
def test_tie_plateau_across_block_boundaries(blocks):
    """Every row holds the same best score on a band of rows that crosses
    every block boundary: the lowest rows must win, from the first block
    on, though later blocks hold equal scores."""
    n, tile_rows, k = 1600, 8, 48
    emb, q = _exact(n, 3)
    top = q.copy()  # scores 1: above any other row (at most 1/4)
    tiles = -(-n // tile_rows)
    edges = [b * tiles // blocks * tile_rows for b in range(1, blocks)]
    band = np.concatenate([np.arange(e - 6, e + 6) for e in edges])
    emb[band] = top
    _, got = _check(emb, q, k, tile_rows, blocks)
    assert (got[: min(k, len(band))] == 1.0).all()


def test_ascending_scores_every_row_enters():
    n, d = 900, 32
    emb = np.zeros((n, d), np.float32)
    emb[:, 0] = np.arange(n) / 1024  # exact in f32 and bf16
    q = np.eye(d, dtype=np.float32)[0]
    for tile_rows, blocks in ((8, 4), (64, 1)):
        _check(emb, q, 48, tile_rows, blocks)


@pytest.mark.parametrize("n", [1, 40, 47])
def test_fewer_rows_than_k(n):
    emb, q = _exact(n, n)
    tile, blocks = topk._stream_layout(n, emb.shape[1], 2, sms=132)
    _, got = _check(emb, q, 48, tile, blocks)
    assert (got[n:] == NEG).all()


def test_all_negative_scores():
    rng = np.random.default_rng(9)
    emb = -(rng.integers(1, 4, (700, 64)) / 16).astype(np.float32)
    q = np.zeros(64, np.float32)
    q[:4] = 0.5
    _check(emb, q, 48, 16, 6)


@pytest.mark.parametrize("n,d,itemsize", [
    (1 << 20, 512, 2), (1 << 20, 512, 4), (70_001, 768, 2), (40, 512, 2),
    (132 * 32 + 1, 512, 2), (100, 2048, 4), (10, 64, 2),
])
def test_layout_covers_the_rows_in_ascending_ranges(n, d, itemsize):
    """The wrapper's layout: slots of at most 32 KB and 64 rows, one block
    per SM or one per tile; the blocks' tile ranges cover every tile once,
    in ascending order, each block at least one."""
    tile, blocks = topk._stream_layout(n, d, itemsize, sms=132)
    assert 1 <= tile <= 64 and tile * d * itemsize <= topk._STREAM_SLOT_BYTES
    tiles = -(-n // tile)
    assert blocks == min(132, tiles)
    ranges = [(b * tiles // blocks, (b + 1) * tiles // blocks) for b in range(blocks)]
    assert ranges[0][0] == 0 and ranges[-1][1] == tiles
    assert all(a[1] == b[0] and a[0] < a[1] for a, b in zip(ranges, ranges[1:] + [(tiles, tiles + 1)]))
    # the early-merge threshold and the tile both fit the buffer
    assert topk._STREAM_BUF - tile >= tile


def test_kernel_source_holds_the_wrappers_constants():
    src = SRC.read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(consts["MAX_SLOT_BYTES"]) == topk._STREAM_SLOT_BYTES
    assert int(consts["MAX_TILE_ROWS"]) == topk._STREAM_MAX_TILE_ROWS
    assert int(consts["MAX_BLOCKS"]) == topk._STREAM_MAX_BLOCKS
    assert int(consts["BUF"]) == topk._STREAM_BUF
    assert int(consts["MAX_D"]) == topk._STREAM_MAX_D
    # a power of two: the merge's bitonic sort pads the buffer up to one
    assert topk._STREAM_BUF & (topk._STREAM_BUF - 1) == 0
    # the ring and the block's selection fit the SM's 227 KB; the final
    # merge's two list regions at MAX_BLOCKS lists of 128 do too
    assert int(consts["STAGES"]) * topk._STREAM_SLOT_BYTES + 4 * 128 * 4 + 8 * topk._STREAM_BUF \
        <= 227 * 1024
    blocks = topk._STREAM_MAX_BLOCKS
    assert (blocks + (blocks + 1) // 2) * 128 * 8 <= 227 * 1024


def test_wrapper_refuses_rows_wider_than_the_query_registers():
    with pytest.raises(ValueError):
        topk.fused_topk(torch.zeros((10, topk._STREAM_MAX_D + 8)), torch.ones(2056), 5)
