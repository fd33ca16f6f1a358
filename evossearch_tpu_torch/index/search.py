"""Single-device exact top-k search over an embedding matrix — PyTorch
counterpart of ``evossearch_tpu/index/search.py``.

Embeddings are L2-normalized at encode time, so inner product == cosine,
and exact top-k is one (Q, N) product plus a selection. Routing follows
the JAX package: corpora of 2^18 rows and up on the card go through the
one-pass candidate kernels (``ops/topk.py``), certified per query, with
the dense exact path as the fallback for uncertified rows; smaller
corpora, and every corpus on the CPU, take the dense exact path.

Determinism contract: ties broken by LOWER row index. Scores are float32
in every path: a bf16 corpus is scored against queries rounded to bf16,
widened exactly, accumulated in float32.

The JAX package's ``certified`` route (an approximate TPU top-k plus a
certificate) has no counterpart: it becomes the dense exact path, whose
results are the certified results by construction.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import topk as _topk
from .store import as_float32, bf16_bits

# Round trips of the packed fast paths: each packed search is one kernel
# pass plus one device->host copy; uncertified rows add a fallback pass.
# Diagnostic only: unlocked increments, approximate under concurrency.
DISPATCH_COUNTS = {"kernel": 0, "fetch": 0, "fallback": 0}


def dispatch_counts_snapshot() -> dict:
    return dict(DISPATCH_COUNTS)


# Corpus rows from which the candidate kernels take over on the card.
_FAST_PATH_MIN_ROWS = 1 << 18

# Max corpus rows a packed result can carry: indices ride in float32
# VALUES, exact integers up to 2**24.
_PACK_MAX_ROWS = 1 << 24


def _as_queries(queries, emb: torch.Tensor) -> torch.Tensor:
    """Queries as a 2-D float32 tensor on the corpus device."""
    q = torch.as_tensor(queries, dtype=torch.float32, device=emb.device)
    return q.reshape(1, -1) if q.dim() == 1 else q


def _topk_batch(emb: torch.Tensor, queries: torch.Tensor, k: int):
    """Dense exact top-k: (Q, N) float32 scores, stable selection.
    Returns (scores (Q, k) f32, rows (Q, k) int64) tensors."""
    return _topk.stable_topk(_topk.dense_scores(emb, queries), k)


def packed_topk(emb: torch.Tensor, queries: torch.Tensor, k: int,
                flavor: str) -> torch.Tensor:
    """(Q, 2k+1) float32 [scores | float(indices) | ok] on the corpus
    device. ``block``/``tree`` run the candidate kernels; ``exact`` the
    dense path (ok always 1). Indices ride as float32 values (exact below
    2**24; callers route larger corpora elsewhere)."""
    queries = _as_queries(queries, emb)
    if flavor == "block":
        ok, s, i = _topk.fused_topk_batch(emb, queries, k)
    elif flavor == "tree":
        ok, s, i = _topk.fused_topk_batch_tree(emb, queries, k)
    else:
        s, i = _topk_batch(emb, queries, k)
        ok = torch.ones(s.shape[0], dtype=torch.bool, device=s.device)
    return torch.cat([s, i.float(), ok[:, None].float()], dim=1)


def choose_packed_flavor(n: int, d: int, k: int, dtype, kernel: str,
                         on_cpu: bool) -> str:
    """Per-corpus packed-kernel choice, mirroring pallas_search_batch /
    best_exact_search_batch / exact_search_batch, so a fused caller picks
    the kernel the two-stage path would. ``on_cpu``: the corpus lies on
    the CPU, where ``best`` takes the dense path (the JAX package's CPU
    backend rule). Callers keep n < _PACK_MAX_ROWS themselves."""
    if kernel in ("pallas", "best"):
        eligible = d % 128 == 0 and 0 < k <= 128 and 512 <= n < _PACK_MAX_ROWS
        if kernel == "best" and (on_cpu or n < _FAST_PATH_MIN_ROWS):
            eligible = False
        if eligible:
            return "tree" if _topk.use_tree_kernel(n, k, dtype) else "block"
    return "exact"


def query_row_bucket(q: int) -> int:
    """Query-row bucket ladder of the serving path: {1, 8, 64} then
    powers of two (the JAX package's, kept so both packages run their
    kernels at the same query counts)."""
    for pad in (1, 8, 64):
        if q <= pad:
            return pad
    pad = 128
    while pad < q:
        pad <<= 1
    return pad


def _unpack_with_fallback(packed: np.ndarray, emb: torch.Tensor,
                          queries_d: torch.Tensor, k: int):
    """Unpack a (Q, 2k+1) [scores | float(indices) | ok] result and re-run
    the dense exact path for any uncertified rows."""
    s = packed[:, :k].copy()
    i = packed[:, k : 2 * k].astype(np.int64)
    ok = packed[:, -1] > 0
    if not ok.all():
        DISPATCH_COUNTS["fallback"] += 1
        fail = np.flatnonzero(~ok)
        rows = torch.from_numpy(fail).to(queries_d.device)
        slow_s, slow_i = _topk_batch(emb, queries_d[rows], k)
        s[fail] = slow_s.cpu().numpy()
        i[fail] = slow_i.cpu().numpy()
    return s, i


def _empty(nq: int):
    return np.zeros((nq, 0), np.float32), np.zeros((nq, 0), np.int64)


def exact_search_batch(emb: torch.Tensor, queries, k: int):
    """Batched exact top-k: queries (Q, d) -> (scores (Q,k), indices (Q,k))
    numpy arrays."""
    queries = _as_queries(queries, emb)
    k = min(k, emb.shape[0])
    if k == 0:
        return _empty(queries.shape[0])
    s, i = _topk_batch(emb, queries, k)
    return s.cpu().numpy(), i.cpu().numpy()


def pallas_search_batch(emb: torch.Tensor, queries, k: int):
    """Exact batched top-k through the one-pass candidate kernels (the
    JAX package's Pallas route; the name is kept for the reader).

    Multi-million-row corpora take the tree kernel, smaller ones the
    block kernel (``use_tree_kernel``); uncertified rows re-run on the
    dense path. Shapes the kernels do not take (d % 128, k > 128,
    n < 512 or n >= 2^24) go to ``exact_search_batch``. Queries run in
    chunks of 128, the kernels' limit. A corpus on the CPU runs the
    kernels' plain versions."""
    n, d = emb.shape
    k = min(k, n)
    if d % 128 or k > 128 or n < 512 or n >= _PACK_MAX_ROWS:
        return exact_search_batch(emb, queries, k)
    queries_d = _as_queries(queries, emb)
    if k == 0:
        return _empty(queries_d.shape[0])
    flavor = "tree" if _topk.use_tree_kernel(n, k, emb.dtype) else "block"
    outs = []
    for start in range(0, queries_d.shape[0], 128):
        DISPATCH_COUNTS["kernel"] += 1
        DISPATCH_COUNTS["fetch"] += 1
        outs.append(
            packed_topk(emb, queries_d[start : start + 128], k, flavor)
            .cpu().numpy()
        )
    packed = outs[0] if len(outs) == 1 else np.concatenate(outs, axis=0)
    return _unpack_with_fallback(packed, emb, queries_d, k)


def best_exact_search_batch(emb: torch.Tensor, queries, k: int):
    """The auto policy: the candidate kernels for every corpus of 2^18
    rows and up on the card; the dense exact path below that (a handful
    of 256-row blocks would fail the block certificate for nearly every
    query) and on the CPU."""
    if emb.device.type != "cpu" and emb.shape[0] >= _FAST_PATH_MIN_ROWS:
        return pallas_search_batch(emb, queries, k)
    return exact_search_batch(emb, queries, k)


def exact_search(emb: torch.Tensor, query, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Exact top-k by inner product of one query.

    emb: (N, d) float32 or bfloat16 tensor (a float32 numpy array is taken
    to the CPU). query: (d,) float32. Returns (scores (k,), indices (k,))
    numpy arrays sorted by descending score, ties by lower row — the same
    contract as FAISS index.search with a single query row. Routed as one
    query row of ``best_exact_search_batch``: on the card, a corpus of
    2^18 rows and up goes through the candidate kernels."""
    emb = torch.as_tensor(emb)
    s, i = best_exact_search_batch(emb, _as_queries(query, emb), k)
    return s[0], i[0]


# -- host scans over the store's mmap shards (over-budget corpora) --


def _host_queries(queries, emb: np.ndarray) -> np.ndarray:
    """float32 queries, rounded to bf16 first for a bf16 store (the same
    contract as every device path)."""
    queries = np.asarray(queries, np.float32)
    if emb.dtype == np.uint16:
        queries = as_float32(bf16_bits(queries))
    return queries


def exact_search_host(emb: np.ndarray, query: np.ndarray, k: int):
    """Exact top-k of one query over a host-resident (or mmap) shard
    through the native threaded scanner, zero-copy: a bf16 shard (uint16
    bits) is widened inside the scan loop, never copied to float32. Same
    tie contract as the device paths. numpy only when the extension is
    unavailable."""
    from ..preprocess.io import get_native

    query = np.ascontiguousarray(_host_queries(query, emb), np.float32)
    n, d = emb.shape
    k = min(k, n)
    if k == 0:
        return np.zeros((0,), np.float32), np.zeros((0,), np.int64)
    native = get_native()
    if native is not None:
        if emb.dtype == np.uint16:
            scan, rows = native.topk_bf16, np.ascontiguousarray(emb)
        else:
            scan, rows = native.topk, np.ascontiguousarray(emb, np.float32)
        scores, idx = scan(rows.data, n, d, query.data, k)
        return np.asarray(scores, np.float32), np.asarray(idx, np.int64)
    scores = as_float32(emb) @ query
    order = np.lexsort((np.arange(n), -scores))[:k]
    return scores[order].astype(np.float32), order.astype(np.int64)


def exact_search_host_reader(reader, query: np.ndarray, k: int):
    """Host exact top-k straight over a reader's mmap shards (each scanned
    in place by ``exact_search_host``), merged with global row offsets."""
    k = min(k, reader.count)
    if k == 0:
        return np.zeros((0,), np.float32), np.zeros((0,), np.int64)
    best_s: list[np.ndarray] = []
    best_i: list[np.ndarray] = []
    offset = 0
    for shard in reader.shard_arrays():
        s, i = exact_search_host(shard, query, min(k, shard.shape[0]))
        best_s.append(s)
        best_i.append(i + offset)
        offset += shard.shape[0]
    cand_s = np.concatenate(best_s)
    cand_i = np.concatenate(best_i)
    order = np.lexsort((cand_i, -cand_s))[:k]
    return cand_s[order], cand_i[order]


_HOST_BATCH_BLOCK = 16384  # rows per GEMM block (f32 transient <= 32 MB)


def exact_search_host_batch(emb: np.ndarray, queries: np.ndarray, k: int):
    """Batched exact top-k over ONE host-resident (or mmap) shard: each
    row block is read once and scored against all queries with one GEMM.
    argpartition is tie-arbitrary at the k-th score, so the boundary is
    re-split into rows strictly above it plus the LOWEST-index rows at
    it — the (score desc, row asc) contract without an (N, Q) matrix."""
    queries = _host_queries(queries, emb)
    qt = np.ascontiguousarray(queries.T)  # (d, Q)
    n = emb.shape[0]
    nq = queries.shape[0]
    k = min(k, n)
    if k == 0 or nq == 0:
        return np.zeros((nq, k), np.float32), np.zeros((nq, k), np.int64)
    cand_s: list[list[np.ndarray]] = [[] for _ in range(nq)]
    cand_i: list[list[np.ndarray]] = [[] for _ in range(nq)]
    for start in range(0, n, _HOST_BATCH_BLOCK):
        s = as_float32(emb[start : start + _HOST_BATCH_BLOCK]) @ qt  # (B, Q)
        b = s.shape[0]
        part = np.argpartition(-s, k - 1, axis=0)[:k] if b > k else None
        for qi in range(nq):
            col = s[:, qi]
            if part is None:
                rows = np.arange(b)
            else:
                kth = col[part[:, qi]].min()
                sure = np.flatnonzero(col > kth)
                ties = np.flatnonzero(col == kth)[: k - len(sure)]
                rows = np.concatenate([sure, ties])
            cand_s[qi].append(col[rows])
            cand_i[qi].append(rows + start)
    out_s = np.empty((nq, k), np.float32)
    out_i = np.empty((nq, k), np.int64)
    for qi in range(nq):
        ss = np.concatenate(cand_s[qi])
        ii = np.concatenate(cand_i[qi]).astype(np.int64)
        order = np.lexsort((ii, -ss))[:k]
        out_s[qi] = ss[order]
        out_i[qi] = ii[order]
    return out_s, out_i


def exact_search_host_reader_batch(reader, queries: np.ndarray, k: int):
    """Batched host exact top-k over a reader's mmap shards — the
    engine's over-budget route. Each shard is swept once for the batch."""
    queries = np.asarray(queries, np.float32)
    nq = queries.shape[0]
    k = min(k, reader.count)
    if k == 0 or nq == 0:
        return np.zeros((nq, k), np.float32), np.zeros((nq, k), np.int64)
    if nq == 1:
        s, i = exact_search_host_reader(reader, queries[0], k)
        return s[None], i[None]
    parts_s: list[np.ndarray] = []
    parts_i: list[np.ndarray] = []
    offset = 0
    for shard in reader.shard_arrays():
        s, i = exact_search_host_batch(shard, queries, min(k, shard.shape[0]))
        parts_s.append(s)
        parts_i.append(i + offset)
        offset += shard.shape[0]
    cs = np.concatenate(parts_s, axis=1)
    ci = np.concatenate(parts_i, axis=1)
    out_s = np.empty((nq, k), np.float32)
    out_i = np.empty((nq, k), np.int64)
    for qi in range(nq):
        order = np.lexsort((ci[qi], -cs[qi]))[:k]
        out_s[qi] = cs[qi][order]
        out_i[qi] = ci[qi][order]
    return out_s, out_i
