"""The walk that B2's tensor-core kernel relies on, on the CPU, where no
kernel runs.

The bf16 path of the block kernel (``ops/csrc/topk_block.cu``,
``block_tc_kernel``) gives one CUDA block to each 2048-row tile, 8 of
B2's 256-row blocks. Rank r of its walk stages rows r*R .. r*R+R-1 of
every block, block w as ring group w (one bulk copy each), so slab column
w*R + i holds block w's row r*R + i; thread (w, lane) then inserts those R
dots of each of its queries into a running top-LEV with strict ">". These
tests pin that the map covers each row of a tile once and in ascending
order within each block, that a numpy model of the walk equals the plain
version and the JAX package's Pallas kernel in interpret mode, and that
the bytes copier thread 0 posts on the barrier are those of the rank's
live rows. The kernel itself is held against the plain version in
tests/test_torch_gpu.py and chip_smoke.py."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evossearch_tpu.ops import topk_pallas as ref
from evossearch_tpu_torch.ops import topk

TILE, SUB, GROUPS = topk.TILE_ROWS, topk.SUB_ROWS, topk.TILE_ROWS // topk.SUB_ROWS
NEG = np.float32(topk.NEG_INF)
D, Q = 128, 5
ROWS = (2048, 3 * 2048 + 77, 300)  # one whole tile; partial tiles with blocks past n


def _rank_rows(r_rows: int) -> np.ndarray:
    """(ranks, 8, R): the tile-relative rows of rank r, group w, row i."""
    r = np.arange(SUB // r_rows)[:, None, None]
    w = np.arange(GROUPS)[None, :, None]
    i = np.arange(r_rows)[None, None, :]
    return w * SUB + r * r_rows + i


@pytest.mark.parametrize("r_rows", [2, 4])
def test_rank_map_covers_a_tile_once_ascending_in_each_block(r_rows):
    rows = _rank_rows(r_rows)
    assert np.array_equal(np.sort(rows.ravel()), np.arange(TILE))
    for w in range(GROUPS):
        walk = rows[:, w, :].ravel()  # block w's rows in (rank, row) order
        assert np.array_equal(walk, w * SUB + np.arange(SUB))
    # one bulk copy per group: its R rows are contiguous
    assert (np.diff(rows, axis=2) == 1).all()


def _insert(s, ix, v, i):
    """evs::insert over arrays: v enters the descending list s with strict
    ">", so an equal score already in the list stays ahead."""
    for j in range(s.shape[-1] - 1, 0, -1):
        up, here = v > s[..., j - 1], v > s[..., j]
        s[..., j] = np.where(up, s[..., j - 1], np.where(here, v, s[..., j]))
        ix[..., j] = np.where(up, ix[..., j - 1], np.where(here, i, ix[..., j]))
    top = v > s[..., 0]
    s[..., 0] = np.where(top, v, s[..., 0])
    ix[..., 0] = np.where(top, i, ix[..., 0])


def _kernel_model(emb: np.ndarray, queries: np.ndarray, levels: int, r_rows: int):
    """The kernel's walk in numpy: per rank the (Q, tiles, C) slab of dots
    (rows at or past n read NEG_INF), block w's R slab columns inserted in
    ascending row order, then the epilogue's layout (levels, L, Q) /
    (levels - 1, L, Q), a NEG_INF level naming its block's first row."""
    n = emb.shape[0]
    tiles = -(-n // TILE)
    scores = np.full((len(queries), tiles * TILE), NEG, np.float32)
    scores[:, :n] = queries @ emb.T
    s = np.full((len(queries), tiles * GROUPS, levels), -np.inf, np.float32)
    ix = np.zeros(s.shape, np.int64)
    for r, rank in enumerate(_rank_rows(r_rows)):
        rows = np.arange(tiles)[:, None] * TILE + rank.reshape(1, -1)  # (tiles, C)
        slab = np.where(rows < n, scores[:, rows], NEG)                # (Q, tiles, C)
        per_block = slab.reshape(len(queries), tiles * GROUPS, r_rows)
        for i in range(r_rows):
            _insert(s, ix, per_block[..., i], r * r_rows + i)
    base = np.arange(tiles * GROUPS)[None, :, None] * SUB
    rows = base + np.where(s[..., : levels - 1] == NEG, 0, ix[..., : levels - 1])
    return s.transpose(2, 1, 0), rows.transpose(2, 1, 0).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _cases(n: int, levels: int):
    """Tie-heavy exact inputs (integers in [-2, 2] over 16: every dot is
    exact, and most blocks hold equal scores) and the JAX package's
    outputs for them in interpret mode, cut to the Q real queries."""
    rng = np.random.default_rng(n + levels)
    emb = (rng.integers(-2, 3, (n, D)) / 16).astype(np.float32)
    queries = (rng.integers(-2, 3, (Q, D)) / 16).astype(np.float32)
    padded = np.concatenate([queries, np.zeros((ref.LANES - Q, D), np.float32)])
    ss, ii, cert = ref._block_candidates(
        jnp.asarray(emb), jnp.asarray(padded), interpret=True, levels=levels)
    want_s = np.stack([np.asarray(a)[:, :Q] for a in (*ss, cert)])
    want_i = np.stack([np.asarray(a)[:, :Q] for a in ii])
    return emb, queries, want_s, want_i


@pytest.mark.parametrize("r_rows", [2, 4])
@pytest.mark.parametrize("levels", [3, 4])
@pytest.mark.parametrize("n", ROWS)
def test_kernel_walk_equals_plain_and_pallas(n, levels, r_rows):
    emb, queries, want_s, want_i = _cases(n, levels)
    got_s, got_i = _kernel_model(emb, queries, levels, r_rows)
    plain_s, plain_i = topk.block_candidates_plain(
        torch.from_numpy(emb), torch.from_numpy(queries), levels)
    np.testing.assert_array_equal(got_s, plain_s.numpy())
    np.testing.assert_array_equal(got_i, plain_i.numpy())
    np.testing.assert_array_equal(got_s, want_s)
    np.testing.assert_array_equal(got_i, want_i)
    # the inputs do tie: some block's best score is held by several rows
    dots = np.full((Q, -(-n // TILE) * TILE), NEG, np.float32)
    dots[:, :n] = queries @ emb.T
    blocks = dots.reshape(Q, -1, SUB)
    assert ((blocks == blocks.max(axis=2, keepdims=True)).sum(axis=2) > 1).any()


@pytest.mark.parametrize("r_rows", [2, 4])
@pytest.mark.parametrize("n", ROWS + (2048 + 1, 2048 + 255, 2048 + 257))
def test_tail_copy_count_is_the_live_rows_bytes(n, r_rows):
    """Copier thread 0 posts sum_w clamp(n - base_w, 0, R) * d * 2 bytes
    (base_w = tile*2048 + w*256 + r*R) for rank r; the groups' bulk copies
    bring exactly the rank's live rows, so every rank's barrier completes,
    a rank with no live row at once."""
    d = 512
    rank_rows = _rank_rows(r_rows)
    for tile in range(-(-n // TILE)):
        for r, rank in enumerate(rank_rows):
            bases = tile * TILE + rank[:, 0]
            posted = int(np.clip(n - bases, 0, r_rows).sum()) * d * 2
            live = int((tile * TILE + rank < n).sum())
            assert posted == live * d * 2, (tile, r)
