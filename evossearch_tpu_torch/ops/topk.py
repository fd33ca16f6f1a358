"""Certified exact top-k: the candidate kernels, the single-query
streaming kernel, their plain versions, and the merge + certificate glue
around them.

Counterpart of ``evossearch_tpu/ops/topk_pallas.py``. Each candidate
kernel makes ONE pass over an (N, d) corpus for up to 128 queries and
keeps a few candidates per fixed partition of the rows, plus a bound on
everything it dropped; a plain-torch merge then selects the top k from the
candidates and certifies per query that nothing dropped could have entered
it. Uncertified queries (adversarial mass ties) are the caller's to re-run
on the dense exact path.

``block`` (B2, ``csrc/topk_block.cu``): per 256-row block, the top
  ``levels - 1`` rows under (score desc, row asc) and the ``levels``-th
  score as the bound, on the copy, query and MMA phases of
  ``csrc/topk_tc.cuh``'s tensor-core kernel.
``tree`` (B1, ``csrc/topk_tree.cu``): per (tile, residue class
  ``row % 128``), the reference halving tree's top-2 rows and its
  third-best score as the bound, on ``csrc/topk_tc.cuh``'s tensor-core
  residue-class kernel.
``sq8`` (B3, ``csrc/topk_sq8.cu``): the tree's selection over certified
  upper bounds ``<e8, bf16(q)> * scale + ||q|| * radd`` of an int8 corpus
  (the SQ8 capacity tier, ``index/sq8.py``), on the tensor cores with
  B1's bf16 kernel (``csrc/topk_tc.cuh``), int8 widened exactly to bf16.
``sq8_variant`` (E1, ``csrc/topk_sq8.cu``): B3 with one piece taken out,
  to split its time (``scripts/exp_sq8_perf.py``): ``bf16_struct`` (B3's
  bound over a bf16 corpus) and ``int8_noscale`` (the raw int8 dot). No
  search uses them.
``stream`` (B4, ``csrc/topk_stream.cu``): the exact top-k of ONE query,
  normalized in the kernel (``fused_topk``; a library entry point, no
  engine route uses it).

Each wrapper (``block_candidates``, ``tree_candidates``,
``sq8_candidates``, ``sq8_variant_candidates``, ``fused_topk``) launches
its CUDA kernel for a tensor on a CUDA device and runs the plain torch
version (``*_plain``) only for a tensor on the CPU; anything else raises. The plain versions compute the
same function and are what the CPU tests hold against the reference's
Pallas kernels in interpret mode.

Numerics: a bf16 corpus is scored against queries rounded to bf16 first,
bf16 widened exactly to f32 and accumulated in f32; an f32 corpus against
the unrounded queries, in three TF32 passes on the tensor cores (the
reference's f32 ``Precision.HIGHEST`` is three bf16 passes), within
``(2^-19 + 2*d*2^-24) * sum|x_k*q_k|`` of the exact dot (the error model
is in ``csrc/topk_tc.cuh``) and exact where every value has at most 11
significant bits and every partial sum is exact in f32; the plain versions
score in IEEE f32. The SQ8
sweep always rounds its queries to bf16; ``fused_topk`` never does (IEEE
f32 FMAs). Scores are f32 throughout. Tie contract: (score desc, row
asc).
Shapes: k <= 128, Q <= 128 per call, d % 128 == 0 (``fused_topk``: d % 8,
d <= 2048).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

LANES = 128
NEG_INF = float(np.finfo(np.float32).min)

# Rows per block of the block kernel; each block yields ``levels`` scores
# and ``levels - 1`` rows (the last score is the certification bound).
SUB_ROWS = 256
LEVELS = 4
_LEVELS3_MIN_ROWS = 4 << 20
# Output rows of the block kernel are padded to whole 2048-row tiles (the
# reference's grid), so the candidate layout matches it cell for cell.
TILE_ROWS = 2048
_SUBS_PER_TILE = TILE_ROWS // SUB_ROWS
TREE_CLASSES = LANES
# Exact top-(k + pad) fetch of the tree merge: a tie plateau wider than
# the pad fails the counting certificate and takes the exact fallback.
_TREE_FETCH_PAD = 32
# ``stable_topk`` keeps the full sort up to this many scores, and for rows
# shorter than _FETCH_MIN_RATIO fetches. On an NVIDIA H100 (chip_smoke.py
# phase dense_topk_c2, times in PERF.md) the fetch, whose launches the host
# paces, overtook the sort between 8 and 16 rows of 262,143 scores (k =
# 48) on one host and between 16 and 48 on another, and the sort was the
# faster on the plain candidate versions' rows of 128 and 256 scores at
# k = 3 and 4.
_SORT_MAX_SCORES = 1 << 22
_FETCH_MIN_RATIO = 32

# Kernel launches per wrapper, counted where the CUDA kernel is launched
# and nowhere else (plain CPU runs do not count).
LAUNCHES = {"block": 0, "tree": 0, "sq8": 0, "sq8_variant": 0, "stream": 0}

# The stream kernel's layout and selection (csrc/topk_stream.cu holds the
# same values): rows per ring slot fill 32 KB, at most 64; one block per
# SM, at most 144 (the blocks' lists fit the final merge's shared memory);
# the block's candidate buffer; the widest row whose query slice a lane
# holds in registers.
_STREAM_SLOT_BYTES = 32768
_STREAM_MAX_TILE_ROWS = 64
_STREAM_MAX_BLOCKS = 144
_STREAM_BUF = 256
_STREAM_MAX_D = 2048

# SQ8 tile: one 256-candidate block per 32768 rows, half the tree kernel's
# bf16 candidate density (topk_pallas.py:653-661). The certificate's
# failure rate and the merge's work depend on it, so it stays the
# reference's value.
SQ8_TILE_ROWS = 32768
# E1's variants of the SQ8 sweep and the corpus dtype each takes
SQ8_VARIANTS = {"bf16_struct": torch.bfloat16, "int8_noscale": torch.int8}


def default_levels(n_rows: int) -> int:
    """Selection depth of the block kernel for an ``n_rows`` corpus:
    3 from ~4.2M rows (where three of the top k rarely share a block),
    else 4 (topk_pallas.py:191)."""
    return 3 if n_rows >= _LEVELS3_MIN_ROWS else LEVELS


def _tree_tile_rows(dtype) -> int:
    """Tree-kernel tile rows: the reference's 16384 for bf16 corpora and
    8192 for f32. The routing (``use_tree_kernel``) and the certification
    rate depend on it, so it stays the reference's value."""
    return 16384 if dtype == torch.bfloat16 else 8192


def use_tree_kernel(n_rows: int, k: int, dtype) -> bool:
    """Routing policy of topk_pallas.py:698-715: the tree kernel when a
    query's failure chance C(k, 3) / classes^2 is at most ~1e-3, over
    classes = n_rows / (tile / 128) residue classes."""
    classes = n_rows // max(_tree_tile_rows(dtype) // TREE_CLASSES, 1)
    if classes < 1024:
        return False
    return math.comb(k, 3) <= 1e-3 * classes * classes


def tree_rank_order(groups: int) -> list[int]:
    """Groups of one residue class in the order the reference's halving
    tree prefers them on ties: ``order[rank] = g``. The tree first pairs
    group g with g + groups/2 (left wins ties), then merges those pairs
    as a balanced tree over bit-reversed positions, so
    rank(g) = 2 * bitrev(g mod groups/2) + (g >= groups/2)."""
    if groups < 2 or groups & (groups - 1):
        raise ValueError(f"groups={groups} must be a power of two >= 2")
    half = groups // 2
    bits = half.bit_length() - 1
    order = [0] * groups
    for g in range(groups):
        low = g % half
        rev = int(f"{low:0{bits}b}"[::-1], 2) if bits else 0
        order[2 * rev + (g >= half)] = g
    return order


# -- scores and exact selection (plain torch; shared with index/search) --

_SCORE_BLOCK = 1 << 16  # corpus rows widened to f32 per product


def prepare_queries(queries: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """Queries as contiguous f32 on the corpus device; rounded to bf16
    first for a bf16 corpus, as every scoring path of the reference does
    (search.py:146)."""
    q = queries.to(device=emb.device, dtype=torch.float32)
    if emb.dtype == torch.bfloat16:
        q = q.to(torch.bfloat16).to(torch.float32)
    return q.contiguous()


def dense_scores(emb: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """(Q, N) f32 scores. bf16 (and int8) rows are widened to f32 block
    by block before the product: a bf16 x bf16 matmul would return bf16
    scores, whose rounding invents ties."""
    q = prepare_queries(queries, emb)
    n = emb.shape[0]
    if emb.dtype == torch.float32:
        return q @ emb.T
    out = torch.empty((q.shape[0], n), dtype=torch.float32, device=emb.device)
    for start in range(0, n, _SCORE_BLOCK):
        blk = emb[start : start + _SCORE_BLOCK].to(torch.float32)
        out[:, start : start + blk.shape[0]] = q @ blk.T
    return out


def _sorted_topk(scores: torch.Tensor, k: int):
    """Top-k along the last axis under (score desc, position asc): a
    stable descending sort of whole rows."""
    vals, pos = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], pos[..., :k]


def stable_topk(scores: torch.Tensor, k: int):
    """Exact top-k along the last axis under (score desc, position asc),
    the same values and positions as a stable descending sort.
    ``torch.topk`` promises nothing on ties, so it fetches the top
    k + ``_TREE_FETCH_PAD`` only; the fetch is ordered by (score desc,
    position asc) and cut to k. A row is certified when the fetch's
    smallest score is strictly below its k-th score m: everything left
    out scores at most that, so every score >= m was fetched and the ties
    at m are settled by position. Rows whose tie plateau at m is wider
    than the pad are redone with the full sort, on those rows only. Up to
    ``_SORT_MAX_SCORES`` scores, and for rows shorter than
    ``_FETCH_MIN_RATIO`` fetches, the full sort is faster on the card and
    is kept."""
    n = scores.shape[-1]
    fetch = k + _TREE_FETCH_PAD
    if scores.numel() <= _SORT_MAX_SCORES or k < 1 or n < _FETCH_MIN_RATIO * fetch:
        return _sorted_topk(scores, k)
    x = scores.reshape(-1, n)
    pos = torch.topk(x, fetch, dim=-1, sorted=False).indices.sort(dim=-1).values
    vals, o = x.gather(-1, pos).sort(dim=-1, descending=True, stable=True)
    pos = pos.gather(-1, o)
    ok = vals[:, -1] < vals[:, k - 1]
    vals, pos = vals[:, :k], pos[:, :k]
    if not bool(ok.all()):
        redo = (~ok).nonzero()[:, 0]
        vals[redo], pos[redo] = _sorted_topk(x[redo], k)
    shape = scores.shape[:-1] + (k,)
    return vals.reshape(shape), pos.reshape(shape)


def sort_by_score_then_index(cand_s: torch.Tensor, cand_i: torch.Tensor, k: int):
    """Order (Q, C) candidates by (score desc, index asc), keep k: a stable
    sort by index, then a stable sort by score (search.py:91-99)."""
    o = torch.argsort(cand_i, dim=1, stable=True)
    s = cand_s.gather(1, o)
    i = cand_i.gather(1, o)
    o = torch.argsort(s, dim=1, descending=True, stable=True)[:, :k]
    return s.gather(1, o), i.gather(1, o)


def _padded_scores(emb: torch.Tensor, queries: torch.Tensor, rows: int):
    s = dense_scores(emb, queries)
    if rows > s.shape[1]:
        s = torch.nn.functional.pad(s, (0, rows - s.shape[1]), value=NEG_INF)
    return s


# -- the two candidate functions: plain versions --


def block_candidates_plain(emb: torch.Tensor, queries: torch.Tensor, levels: int):
    """Per 256-row block: the top-``levels`` scores under (score desc,
    row asc) and the rows of the first ``levels - 1``; rows past the
    corpus score NEG_INF, and a level that scores NEG_INF names the
    block's first row. Returns (scores (levels, L, Q) f32,
    rows (levels - 1, L, Q) i32), L = cdiv(N, 2048) * 8 — level by level
    the reference's (L, 128-lane) outputs cut to the Q real queries."""
    n = emb.shape[0]
    blocks = -(-n // TILE_ROWS) * _SUBS_PER_TILE
    s = _padded_scores(emb, queries, blocks * SUB_ROWS)
    q = s.shape[0]
    vals, pos = stable_topk(s.view(q, blocks, SUB_ROWS), levels)
    base = torch.arange(blocks, device=s.device, dtype=torch.int64)[:, None] * SUB_ROWS
    # a level past the block's real rows scores NEG_INF and, as in the
    # reference (whose knock-out writes NEG_INF back), names the block's
    # first row
    rows = torch.where(
        vals[..., : levels - 1] == NEG_INF, base, pos[..., : levels - 1] + base
    )
    return (
        vals.permute(2, 1, 0).contiguous(),
        rows.permute(2, 1, 0).to(torch.int32).contiguous(),
    )


def _class_reduce(s: torch.Tensor, tile_rows: int):
    """The tree's residue-class selection over (Q, tiles*tile_rows)
    figures (scores, or SQ8 bounds), padding already at NEG_INF: per
    (tile, class) the top-2 figures with their rows and the third-best
    figure, ties resolved as the reference's halving tree does
    (``tree_rank_order``), in the reference's pre-packed layout."""
    q = s.shape[0]
    tiles = s.shape[1] // tile_rows
    groups = tile_rows // TREE_CLASSES
    order = torch.tensor(tree_rank_order(groups), device=s.device)
    ranked = s.view(q, tiles, groups, TREE_CLASSES)[:, :, order, :]
    vals, pos = stable_topk(ranked.transpose(2, 3), 3)  # (Q, tiles, 128, 3)
    g = order[pos[..., :2]]
    rows = (
        torch.arange(tiles, device=s.device)[:, None, None] * tile_rows
        + g * TREE_CLASSES
        + torch.arange(TREE_CLASSES, device=s.device)[:, None]
    )
    cand_s = vals[..., :2].transpose(2, 3).reshape(q, tiles * 2 * TREE_CLASSES)
    cand_i = rows.transpose(2, 3).reshape(q, tiles * 2 * TREE_CLASSES)
    bound = vals[..., 2].reshape(q, tiles * TREE_CLASSES)
    return cand_s.contiguous(), cand_i.to(torch.int32).contiguous(), bound.contiguous()


def tree_candidates_plain(emb: torch.Tensor, queries: torch.Tensor, tile_rows: int):
    """Per (tile, residue class): the top-2 scores with their rows and the
    third-best score (``_class_reduce``). Returns the reference's
    pre-packed layout: (cand_s (Q, tiles*256) f32, cand_i (Q, tiles*256)
    i32, bound (Q, tiles*128) f32)."""
    tiles = -(-emb.shape[0] // tile_rows)
    return _class_reduce(_padded_scores(emb, queries, tiles * tile_rows), tile_rows)


def sq8_candidates_plain(e8: torch.Tensor, scal2: torch.Tensor,
                         queries: torch.Tensor, qnorm: torch.Tensor,
                         tile_rows: int = SQ8_TILE_ROWS):
    """The SQ8 bound sweep's candidates: ``_class_reduce`` over the (Q, N)
    f32 upper bounds ``<e8, bf16(q)> * scale + ||q|| * radd`` (int8 rows
    widened exactly, f32 products and sums, then two rounded products and
    one rounded sum; topk_pallas.py:560-573), rows past the corpus at
    NEG_INF. Same layout as ``tree_candidates_plain``, with bounds in
    place of scores."""
    n = e8.shape[0]
    tiles = -(-n // tile_rows)
    qn = qnorm.to(device=e8.device, dtype=torch.float32).reshape(-1, 1)
    dot = dense_scores(e8, queries.to(torch.float32).to(torch.bfloat16))
    u = dot * scal2[0] + qn * scal2[1]
    if tiles * tile_rows > n:
        u = torch.nn.functional.pad(u, (0, tiles * tile_rows - n), value=NEG_INF)
    return _class_reduce(u, tile_rows)


def sq8_variant_candidates_plain(corpus: torch.Tensor, scal2, queries: torch.Tensor,
                                 qnorm, variant: str, tile_rows: int = SQ8_TILE_ROWS):
    """E1's variants of the SQ8 sweep, same layout as
    ``sq8_candidates_plain``: ``bf16_struct`` is its bound formula over a
    bf16 corpus; ``int8_noscale`` is ``_class_reduce`` over the raw dots
    ``<e8, bf16(q)>`` of an int8 corpus (``scal2`` and ``qnorm`` unused),
    rows past the corpus at NEG_INF."""
    if variant == "bf16_struct":
        return sq8_candidates_plain(corpus, scal2, queries, qnorm, tile_rows)
    tiles = -(-corpus.shape[0] // tile_rows)
    qb = queries.to(torch.float32).to(torch.bfloat16)
    return _class_reduce(_padded_scores(corpus, qb, tiles * tile_rows), tile_rows)


def fused_topk_plain(emb: torch.Tensor, query: torch.Tensor, k: int):
    """Exact top-k of one query (topk_pallas.py:129): the query normalized
    as ``q * rsqrt(sum(q*q) + 1e-30)`` with a correctly rounded rsqrt
    (float64 reciprocal of the float64 square root, rounded once to
    float32), every row widened exactly and scored in f32 against the f32
    query. Returns (scores (k,) f32, rows (k,) int64) under (score desc,
    row asc); slots past the corpus, and rows scoring NEG_INF, read
    (NEG_INF, -1) as in the reference."""
    q = query.to(device=emb.device, dtype=torch.float32).reshape(-1)
    ss = (q * q).sum() + torch.tensor(1e-30, dtype=torch.float32, device=q.device)
    q = q * (1.0 / torch.sqrt(ss.double())).float()
    n = emb.shape[0]
    s = torch.empty(n, dtype=torch.float32, device=emb.device)
    for start in range(0, n, _SCORE_BLOCK):
        s[start : start + _SCORE_BLOCK] = emb[start : start + _SCORE_BLOCK].to(torch.float32) @ q
    vals, pos = _pad_k(*stable_topk(s[None], min(k, n)), k)
    real = vals[0] > NEG_INF
    return torch.where(real, vals[0], NEG_INF), torch.where(real, pos[0], -1)


# -- wrappers: CUDA kernel for CUDA tensors, plain version for CPU ones --


def _check(emb: torch.Tensor, queries: torch.Tensor) -> None:
    if emb.dim() != 2 or queries.dim() != 2:
        raise ValueError("emb must be (N, d) and queries (Q, d)")
    n, d = emb.shape
    if emb.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"corpus dtype {emb.dtype} is not float32/bfloat16")
    if d % LANES:
        raise ValueError(f"d={d} must be a multiple of {LANES}")
    if queries.shape[1] != d:
        raise ValueError(f"query width {queries.shape[1]} != corpus width {d}")
    if not 0 < queries.shape[0] <= LANES:
        raise ValueError(f"Q={queries.shape[0]} must be in 1..{LANES}")
    if not emb.is_contiguous():
        raise ValueError("corpus must be contiguous")
    if n >= 1 << 31:
        raise ValueError("corpus rows must fit int32")
    if emb.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {emb.device}")


def _launch(name: str, emb: torch.Tensor, args: list) -> None:
    """Launch ``topk_<name>`` on the corpus's device; tensors in ``args``
    pass as their data pointers."""
    from ._build import entry

    fn = entry(f"topk_{name}")
    if emb.data_ptr() % 16:
        raise ValueError("corpus must be 16-byte aligned")
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(emb.device):
        stream = torch.cuda.current_stream(emb.device).cuda_stream
        rc = fn(*args, stream)
    if rc:
        raise RuntimeError(f"topk_{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def block_candidates(emb: torch.Tensor, queries: torch.Tensor, levels: int = LEVELS):
    """The block kernel's candidates (see ``block_candidates_plain``)."""
    _check(emb, queries)
    if levels not in (3, 4):
        raise ValueError(f"levels={levels} must be 3 or 4")
    if emb.device.type == "cpu":
        return block_candidates_plain(emb, queries, levels)
    q = prepare_queries(queries, emb)
    n, d = emb.shape
    nq = q.shape[0]
    blocks = -(-n // TILE_ROWS) * _SUBS_PER_TILE
    out_s = torch.empty((levels, blocks, nq), dtype=torch.float32, device=emb.device)
    out_i = torch.empty((levels - 1, blocks, nq), dtype=torch.int32, device=emb.device)
    _launch("block", emb, [
        emb, int(emb.dtype == torch.bfloat16), q, nq, n, d, levels, blocks, out_s, out_i,
    ])
    return out_s, out_i


def tree_candidates(emb: torch.Tensor, queries: torch.Tensor, tile_rows: int):
    """The tree kernel's candidates (see ``tree_candidates_plain``)."""
    _check(emb, queries)
    if tile_rows < 512 or tile_rows & (tile_rows - 1):
        raise ValueError(f"tile_rows={tile_rows} must be a power of two >= 512")
    if emb.device.type == "cpu":
        return tree_candidates_plain(emb, queries, tile_rows)
    q = prepare_queries(queries, emb)
    n, d = emb.shape
    nq = q.shape[0]
    # the grid holds tiles * (128 / C) blocks in its x dimension, so any
    # int32 row count
    cols = -(-n // tile_rows) * TREE_CLASSES
    cand_s = torch.empty((nq, 2 * cols), dtype=torch.float32, device=emb.device)
    cand_i = torch.empty((nq, 2 * cols), dtype=torch.int32, device=emb.device)
    bound = torch.empty((nq, cols), dtype=torch.float32, device=emb.device)
    _launch("tree", emb, [
        emb, int(emb.dtype == torch.bfloat16), q, nq, n, d, tile_rows, cand_s, cand_i, bound,
    ])
    return cand_s, cand_i, bound


def _check_sq8(corpus: torch.Tensor, dtype, scal2, queries: torch.Tensor,
               qnorm, tile_rows: int) -> None:
    """Arguments of the SQ8 sweep and its variants; ``scal2`` and
    ``qnorm`` may be None only where the caller does not read them."""
    if corpus.dtype != dtype or corpus.dim() != 2 or not corpus.is_contiguous():
        raise ValueError(f"the corpus must be a contiguous (N, d) {dtype} tensor")
    n, d = corpus.shape
    if d % LANES:
        raise ValueError(f"d={d} must be a multiple of {LANES}")
    if scal2 is not None and (scal2.shape != (2, n) or scal2.dtype != torch.float32):
        raise ValueError(f"scal2 must be (2, {n}) float32")
    if queries.dim() != 2 or queries.shape[1] != d:
        raise ValueError(f"queries must be (Q, {d})")
    nq = queries.shape[0]
    if not 0 < nq <= LANES:
        raise ValueError(f"Q={nq} must be in 1..{LANES}")
    if qnorm is not None and qnorm.shape not in ((nq,), (nq, 1)):
        raise ValueError(f"qnorm must hold {nq} norms")
    if tile_rows < 512 or tile_rows & (tile_rows - 1):
        raise ValueError(f"tile_rows={tile_rows} must be a power of two >= 512")
    # the kernel's grid holds tiles * (128 / C) blocks in its x dimension,
    # so any int32 row count
    if n >= 1 << 31:
        raise ValueError("corpus rows must fit int32")
    if corpus.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {corpus.device}")


def _sq8_launch(name: str, corpus: torch.Tensor, scal2, queries: torch.Tensor,
                qnorm, tile_rows: int, head: list):
    """Launch the SQ8 sweep (or a variant, ``head`` = [variant]) on the
    corpus's CUDA device: queries rounded to bf16, outputs allocated."""
    dev = corpus.device
    n, d = corpus.shape
    nq = queries.shape[0]
    q = queries.to(device=dev, dtype=torch.float32)
    q = q.to(torch.bfloat16).to(torch.float32).contiguous()
    qn = sc = None
    if qnorm is not None:
        qn = qnorm.to(device=dev, dtype=torch.float32).reshape(nq).contiguous()
    if scal2 is not None:
        sc = scal2.to(dev).contiguous()
    cols = -(-n // tile_rows) * TREE_CLASSES
    cand_s = torch.empty((nq, 2 * cols), dtype=torch.float32, device=dev)
    cand_i = torch.empty((nq, 2 * cols), dtype=torch.int32, device=dev)
    bound = torch.empty((nq, cols), dtype=torch.float32, device=dev)
    _launch(name, corpus, head + [
        corpus, sc, q, qn, nq, n, d, tile_rows, cand_s, cand_i, bound,
    ])
    return cand_s, cand_i, bound


def sq8_candidates(e8: torch.Tensor, scal2: torch.Tensor, queries: torch.Tensor,
                   qnorm: torch.Tensor, tile_rows: int = SQ8_TILE_ROWS):
    """The SQ8 bound sweep's candidates (see ``sq8_candidates_plain``).
    e8: (N, d) int8; scal2: (2, N) f32 [scale; radd]; queries: (Q, d) f32,
    rounded to bf16 here; qnorm: (Q,) f32 norms of the unrounded queries."""
    if scal2 is None or qnorm is None:
        raise ValueError("the SQ8 sweep needs scal2 and qnorm")
    _check_sq8(e8, torch.int8, scal2, queries, qnorm, tile_rows)
    if e8.device.type == "cpu":
        return sq8_candidates_plain(e8, scal2, queries, qnorm, tile_rows)
    return _sq8_launch("sq8", e8, scal2, queries, qnorm, tile_rows, [])


def sq8_variant_candidates(corpus: torch.Tensor, scal2, queries: torch.Tensor,
                           qnorm, variant: str, tile_rows: int = SQ8_TILE_ROWS):
    """E1's variants of the SQ8 sweep (see
    ``sq8_variant_candidates_plain``). ``bf16_struct``: corpus (N, d) bf16,
    scal2 and qnorm as ``sq8_candidates``; ``int8_noscale``: corpus (N, d)
    int8, scal2 and qnorm unused (may be None). Queries are rounded to bf16
    here."""
    if variant not in SQ8_VARIANTS:
        raise ValueError(f"variant={variant!r} is not one of {sorted(SQ8_VARIANTS)}")
    if variant == "bf16_struct" and (scal2 is None or qnorm is None):
        raise ValueError("bf16_struct needs scal2 and qnorm")
    if variant == "int8_noscale":
        scal2 = qnorm = None
    _check_sq8(corpus, SQ8_VARIANTS[variant], scal2, queries, qnorm, tile_rows)
    if corpus.device.type == "cpu":
        return sq8_variant_candidates_plain(corpus, scal2, queries, qnorm,
                                            variant, tile_rows)
    return _sq8_launch("sq8_variant", corpus, scal2, queries, qnorm, tile_rows,
                       [list(SQ8_VARIANTS).index(variant)])


def _stream_layout(n: int, d: int, itemsize: int, sms: int) -> tuple[int, int]:
    """The stream kernel's (tile rows, blocks) for an (n, d) corpus of
    ``itemsize``-byte elements on a card of ``sms`` SMs: as many rows as
    fill one 32 KB ring slot (at most 64), and a persistent grid of one
    block per SM, never more blocks than tiles (csrc/topk_stream.cu)."""
    tile = max(1, min(_STREAM_MAX_TILE_ROWS, _STREAM_SLOT_BYTES // (d * itemsize)))
    return tile, min(sms, _STREAM_MAX_BLOCKS, -(-n // tile))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def fused_topk(emb: torch.Tensor, query: torch.Tensor, k: int, block_rows: int = 2048):
    """Exact top-k of one query, normalized inside (see
    ``fused_topk_plain``): (scores (k,) f32, rows (k,) int64) under (score
    desc, row asc). ``block_rows`` (a power of two in 128..4096) is the
    reference's tile and is checked as it checks it; the kernel no longer
    tiles by it (it streams ring-slot tiles over a persistent grid,
    ``_stream_layout``), and no result ever depended on it."""
    if emb.dim() != 2 or emb.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("emb must be an (N, d) float32/bfloat16 tensor")
    n, d = emb.shape
    if query.numel() != d:
        raise ValueError(f"query must hold {d} values")
    if not 0 < k <= LANES:
        raise ValueError(f"k={k} must be in 1..{LANES}")
    if block_rows < 128 or block_rows > 4096 or block_rows & (block_rows - 1):
        raise ValueError(f"block_rows={block_rows} must be a power of two in 128..4096")
    if d % 8 or not emb.is_contiguous():
        raise ValueError("emb must be contiguous with d a multiple of 8")
    if d > _STREAM_MAX_D:
        raise ValueError(f"d={d} must be at most {_STREAM_MAX_D}")
    if n >= 1 << 31:
        raise ValueError("corpus rows must fit int32")
    if emb.device.type == "cpu":
        return fused_topk_plain(emb, query, k)
    if emb.device.type != "cuda":
        raise ValueError(f"no kernel for device {emb.device}")
    dev = emb.device
    q = query.to(device=dev, dtype=torch.float32).reshape(d).contiguous()
    tile, blocks = _stream_layout(n, d, emb.element_size(), _sm_count(dev.index))
    list_s = torch.empty(blocks * k, dtype=torch.float32, device=dev)
    list_i = torch.empty(blocks * k, dtype=torch.int32, device=dev)
    out_s = torch.empty(k, dtype=torch.float32, device=dev)
    out_i = torch.empty(k, dtype=torch.int64, device=dev)
    _launch("stream", emb, [
        emb, int(emb.dtype == torch.bfloat16), q, n, d, k, tile, blocks,
        list_s, list_i, out_s, out_i,
    ])
    return out_s, out_i


# -- merges and certificates (plain torch on the candidates) --


def _pad_k(top_s, top_i, k: int):
    if top_s.shape[1] < k:
        pad = k - top_s.shape[1]
        top_s = torch.nn.functional.pad(top_s, (0, pad), value=NEG_INF)
        top_i = torch.nn.functional.pad(top_i, (0, pad), value=-1)
    return top_s, top_i


def fused_topk_batch(emb: torch.Tensor, queries: torch.Tensor, k: int,
                     levels: int | None = None):
    """Certified exact top-k through the block kernel (topk_pallas.py:317).

    Returns (ok (Q,) bool, scores (Q, k) f32, rows (Q, k) int64); rows with
    ok are the exact top-k under (score desc, row asc), the others need the
    caller's exact fallback."""
    n = emb.shape[0]
    if k > LANES:
        raise ValueError(f"k={k} > {LANES} not supported by the kernel")
    if levels is None:
        levels = default_levels(n)
    nc = levels - 1
    ss, ii = block_candidates(emb, queries, levels)
    q, blocks = ss.shape[2], ss.shape[1]
    # (Q, L * nc) laid out block by block, levels within a block: position
    # order is row order among equal scores, so a stable sort keeps the
    # lowest row first
    cand_s = ss[:nc].permute(2, 1, 0).reshape(q, blocks * nc)
    cand_i = ii.permute(2, 1, 0).reshape(q, blocks * nc)
    kk = min(k, blocks * nc)
    top_s, pos = stable_topk(cand_s, kk)
    top_i = cand_i.gather(1, pos).to(torch.int64)
    top_s, top_i = _pad_k(top_s, top_i, k)
    # nothing missed can reach the top k: each block's levels-th best is
    # strictly below the k-th pick
    m = top_s[:, min(k, n) - 1]
    ok = (ss[levels - 1].T < m[:, None]).all(dim=1)
    return ok, top_s[:, :k], top_i[:, :k]


def fused_topk_batch_tree(emb: torch.Tensor, queries: torch.Tensor, k: int):
    """Certified exact top-k through the tree kernel (topk_pallas.py:724).
    Same contract as ``fused_topk_batch``. An exact top-(k+32) fetch takes
    the place of the reference's approximate one; both certificates of
    topk_pallas.py:778-780 are kept as they are."""
    if k > LANES:
        raise ValueError(f"k={k} > {LANES} not supported by the kernel")
    cand_s, cand_i, bound = tree_candidates(emb, queries, _tree_tile_rows(emb.dtype))
    c_total = cand_s.shape[1]
    kk = min(k, c_total)
    fetch = min(kk + _TREE_FETCH_PAD, c_total)
    cs, cpos = torch.topk(cand_s, fetch, dim=1)
    ci = cand_i.gather(1, cpos).to(torch.int64)
    top_s, top_i = sort_by_score_then_index(cs, ci, kk)
    m = top_s[:, kk - 1]
    # (1) every candidate >= m was fetched; (2) everything the kernel
    # dropped scores strictly below m
    ge_all = (cand_s >= m[:, None]).sum(dim=1)
    ge_got = (cs >= m[:, None]).sum(dim=1)
    ok = (ge_all == ge_got) & (bound < m[:, None]).all(dim=1)
    top_s, top_i = _pad_k(top_s, top_i, k)
    return ok, top_s[:, :k], top_i[:, :k]
