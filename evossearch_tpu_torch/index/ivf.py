"""IVF approximate index: spherical k-means coarse centroids + padded
bucket scan — PyTorch counterpart of ``evossearch_tpu/index/ivf.py``.

Vectors are stored in a dense (nlist, bucket_cap, d) tensor, so every
probe is a gather of whole buckets plus one batched product; no ragged
list walking. Vectors that overflow a bucket spill into a dense "tail"
matrix that is ALWAYS scanned exactly, so cluster imbalance degrades to
extra exact work, never to lost recall.

Query: top-nprobe centroids by inner product -> gather those buckets ->
f32 scores + pad mask -> merge with the spill scan -> (score desc, id asc)
top-k. Training: Lloyd iterations of spherical k-means (assignment by max
inner product, centroid update by mean + renormalize) on the device, the
per-cluster sums as one-hot matrix products, chunk by chunk. The product
is deterministic where float atomics (``index_add_``) are not, so a
sidecar built twice from the same corpus is the same file.

Everything here is plain torch: the JAX package computes these steps with
XLA (matrix products, argmax, gathers, sorts), not with a Pallas kernel.

``ivf.npz`` sidecars are byte-compatible with the JAX package's in both
directions (bf16 buckets ride as uint16 bit patterns plus a meta flag).

Differences from the JAX package: ids come back as int64 directly (the
reference packs them into f32 values beside the scores, so that its TPU
route fetches both in one transfer), and the calibration queries' noise is
drawn from a ``torch.Generator`` seeded with the same numpy draw as the
reference's JAX key, so ``tuned_nprobe`` may differ between the packages
by the noise's effect on the rank quantile.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.device import resolve_device
from ..models.layers import matmul_f32
from ..ops.topk import sort_by_score_then_index, stable_topk
from .store import as_float32, bf16_bits

NEG_INF = float(np.finfo(np.float32).min)

# Rows per k-means chunk: peak memory is one chunk x nlist score matrix
# and one-hot matrix, never an (N, nlist) intermediate.
KMEANS_CHUNK = 1 << 15

# Queries per chunk of search_batch: the probed-bucket gather holds
# (chunk, nprobe, cap, d) at the bucket dtype, linear in the chunk.
_IVF_BATCH_CHUNK = 8


def _kmeans(emb: torch.Tensor, init: torch.Tensor, iters: int) -> torch.Tensor:
    """Spherical k-means; emb (N, d) L2-normalized, init (nlist, d) f32.
    Returns (nlist, d) f32 unit centroids. A cluster that loses every row
    keeps its centroid."""
    nlist = init.shape[0]
    cent = init
    for _ in range(iters):
        sums = torch.zeros_like(cent)
        counts = torch.zeros(nlist, dtype=torch.float32, device=cent.device)
        for start in range(0, emb.shape[0], KMEANS_CHUNK):
            x = emb[start : start + KMEANS_CHUNK].float()
            assign = (x @ cent.T).argmax(dim=1)
            oh = torch.nn.functional.one_hot(assign, nlist).float()
            sums += oh.T @ x
            counts += oh.sum(dim=0)
        counts = counts[:, None]
        new = torch.where(counts > 0, sums / counts.clamp(min=1.0), cent)
        cent = new / torch.linalg.norm(new, dim=1, keepdim=True).clamp(min=1e-12)
    return cent


def _assign(emb: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """Chunked nearest-centroid assignment; (N,) int64."""
    return torch.cat([
        (emb[start : start + KMEANS_CHUNK].float() @ cent.T).argmax(dim=1)
        for start in range(0, emb.shape[0], KMEANS_CHUNK)
    ])


def _normalize_keep_dtype(emb: torch.Tensor) -> torch.Tensor:
    """Chunked L2 normalize with f32 math, result in the input dtype: no
    f32 copy of a bf16 corpus, the peak is corpus + output + one chunk."""
    out = torch.empty_like(emb)
    for start in range(0, emb.shape[0], KMEANS_CHUNK):
        x = emb[start : start + KMEANS_CHUNK].float()
        nrm = torch.linalg.norm(x, dim=1, keepdim=True).clamp(min=1e-12)
        out[start : start + KMEANS_CHUNK] = (x / nrm).to(emb.dtype)
    return out


def _scatter_buckets(emb: torch.Tensor, sa_in: torch.Tensor, pos_in: torch.Tensor,
                     rows_in: torch.Tensor, nlist: int, cap: int):
    """Dense (nlist, cap, d) bucket layout at the corpus dtype plus the
    (nlist, cap) int32 row ids (-1 = pad), written in place chunk by chunk:
    peak memory is corpus + buckets + one chunk's gathered rows. Every
    entry handed in lies inside the layout (the reference pads its scan
    with out-of-range entries that its scatter drops; there are none
    here)."""
    buckets = torch.zeros((nlist, cap, emb.shape[1]), dtype=emb.dtype,
                          device=emb.device)
    ids = torch.full((nlist, cap), -1, dtype=torch.int32, device=emb.device)
    for start in range(0, rows_in.shape[0], KMEANS_CHUNK):
        sl = slice(start, start + KMEANS_CHUNK)
        sa, po, ro = sa_in[sl], pos_in[sl], rows_in[sl]
        buckets.index_put_((sa, po), emb[ro])
        ids.index_put_((sa, po), ro.to(torch.int32))
    return buckets, ids


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _to_numpy(a) -> np.ndarray:
    """A tensor (or array) as host numpy; bf16 as its uint16 bit patterns,
    the store's convention."""
    if isinstance(a, np.ndarray):
        return a
    a = a.detach().cpu()
    if a.dtype == torch.bfloat16:
        return a.view(torch.int16).numpy().view(np.uint16)
    return a.numpy()


def _to_tensor(a, device=None) -> torch.Tensor:
    """Host numpy (uint16 = bf16 bit patterns) or a tensor, as a tensor on
    ``device`` (None: where it lies; numpy stays on the CPU, zero-copy)."""
    if isinstance(a, np.ndarray):
        t = torch.from_numpy(a)
        if a.dtype == np.uint16:
            t = t.view(torch.bfloat16)
        a = t
    return a if device is None else a.to(device)


@dataclass
class IVFIndex:
    centroids: torch.Tensor  # (nlist, d) f32
    buckets: torch.Tensor  # (nlist, cap, d) at the corpus dtype
    bucket_ids: torch.Tensor  # (nlist, cap) int32 global row ids, -1 = pad
    spill: torch.Tensor  # (S, d) overflow rows, scanned exactly
    spill_ids: torch.Tensor  # (S,) int32
    n: int
    nlist: int
    tuned_nprobe: int = 0  # recall-calibrated at build; 0 = untuned
    # seconds of each build stage (kmeans, assign, layout, calibrate)
    build_s: dict = field(default_factory=dict, compare=False)

    @classmethod
    def build(
        cls, emb, nlist: int = 0, iters: int = 10,
        bucket_factor: float = 2.0, seed: int = 0,
        tune_target: float | None = 0.995,
        pre_normalized: bool = False,
        device: str | torch.device | None = None,
    ) -> "IVFIndex":
        """Train centroids and lay out buckets from an (N, d) matrix: a
        numpy array (uploaded once to ``device``, None: the GPU, or a
        raise without one) or a tensor (on its own device unless
        ``device`` is given). Buckets and spill keep the corpus dtype
        (bf16 or f32; anything else becomes f32); centroids and all score
        accumulation are f32, so the device holds about
        (1 + bucket_factor) x the corpus bytes.

        ``tune_target``: recall target of the build-time nprobe
        calibration (None disables; see ``_tune_nprobe``).
        ``pre_normalized``: skip the L2 normalize (store rows are unit
        norm at encode time)."""
        if isinstance(emb, torch.Tensor) and device is None:
            dev = emb.device
        else:
            dev = resolve_device(device)
        emb_dev = _to_tensor(emb, dev)
        if emb_dev.dtype not in (torch.float32, torch.bfloat16):
            emb_dev = emb_dev.float()
        n, d = emb_dev.shape
        nlist = nlist or max(1, int(np.sqrt(n)))
        nlist = min(nlist, n)
        rng = np.random.default_rng(seed)
        laps = {}
        t0 = time.perf_counter()
        if pre_normalized:
            emb_n = emb_dev
        elif emb_dev.dtype == torch.float32:
            norms = torch.linalg.norm(emb_dev, dim=1, keepdim=True)
            emb_n = emb_dev / norms.clamp(min=1e-12)
        else:  # bf16: chunked normalize, no f32 corpus copy
            emb_n = _normalize_keep_dtype(emb_dev)
        pick = torch.from_numpy(rng.choice(n, size=nlist, replace=False)).to(dev)
        cent = _kmeans(emb_n, emb_n[pick].float(), iters)
        _sync(dev)
        laps["kmeans"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        assign = _assign(emb_n, cent)
        del emb_n
        _sync(dev)
        laps["assign"] = time.perf_counter() - t0

        # Vectorized bucket layout: stable-sort rows by cluster, compute
        # each row's position within its cluster, scatter rows below the
        # cap into the dense buckets; the rest spill to the exact tail.
        t0 = time.perf_counter()
        cap = max(1, int(np.ceil(n / nlist * bucket_factor)))
        order = torch.argsort(assign, stable=True)
        sorted_assign = assign[order]
        starts = torch.searchsorted(
            sorted_assign, torch.arange(nlist, device=dev))
        pos_within = torch.arange(n, device=dev) - starts[sorted_assign]
        in_bucket = pos_within < cap
        buckets, bucket_ids = _scatter_buckets(
            emb_dev, sorted_assign[in_bucket], pos_within[in_bucket],
            order[in_bucket], nlist=nlist, cap=cap,
        )
        rows_spill = order[~in_bucket]
        spill = emb_dev[rows_spill]
        spill_ids = rows_spill.to(torch.int32)
        _sync(dev)
        laps["layout"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        tuned = 0
        if tune_target is not None and nlist > 1:
            is_spilled = torch.zeros(n, dtype=torch.bool, device=dev)
            is_spilled[rows_spill] = True
            tuned = _tune_nprobe(
                emb_dev, cent, assign, is_spilled, rng, target=tune_target,
            )
        laps["calibrate"] = time.perf_counter() - t0
        return cls(
            centroids=cent, buckets=buckets, bucket_ids=bucket_ids,
            spill=spill, spill_ids=spill_ids, n=n, nlist=nlist,
            tuned_nprobe=tuned, build_s=laps,
        )

    def save(self, path) -> None:
        """Persist the trained index (centroids + bucket layout) so server
        restarts skip k-means. bf16 buckets ride as uint16 bit patterns +
        a meta flag; the keys, dtypes and order are the JAX package's."""
        buckets = _to_numpy(self.buckets)
        is_bf16 = buckets.dtype == np.uint16
        np.savez(
            path,
            centroids=_to_numpy(self.centroids),
            buckets=buckets,
            bucket_ids=_to_numpy(self.bucket_ids),
            spill=_to_numpy(self.spill),
            spill_ids=_to_numpy(self.spill_ids),
            meta=np.asarray(
                [self.n, self.nlist, self.tuned_nprobe, int(is_bf16)], np.int64,
            ),
        )

    @classmethod
    def load(cls, path, host: bool = False,
             device: str | torch.device | None = None) -> "IVFIndex | None":
        """Load a persisted index onto ``device`` (None: the GPU, or a
        raise without one); None for a missing or corrupt file.
        ``host=True`` keeps every array in host numpy (bf16 as uint16
        bits) for ``search_host``: no device bytes, which is what an
        over-budget corpus cannot spare."""
        dev = None if host else resolve_device(device)
        try:
            with np.load(path, allow_pickle=False) as data:
                meta = [int(v) for v in data["meta"]]
                arrays = {key: data[key] for key in (
                    "centroids", "buckets", "bucket_ids", "spill", "spill_ids")}
        except Exception:
            return None
        is_bf16 = bool(meta[3]) if len(meta) > 3 else False
        for key in ("buckets", "spill"):
            a = arrays[key]
            if is_bf16 != (a.dtype == np.uint16):
                return None
        if not host:
            arrays = {key: _to_tensor(a, dev) for key, a in arrays.items()}
        return cls(
            **arrays, n=meta[0], nlist=meta[1],
            tuned_nprobe=meta[2] if len(meta) > 2 else 0,
        )

    def search(self, query, k: int, nprobe: int = 0):
        """Approximate top-k of one (d,) query; FAISS-shaped (scores,
        ids) numpy result, without the pad rows (probes covering fewer
        than k rows give a short result)."""
        q = torch.as_tensor(query, dtype=torch.float32)
        s, i = self.search_batch(q if q.dim() == 2 else q[None], k, nprobe)
        s, i = s[0], i[0]
        valid = i >= 0
        return s[valid], i[valid]

    def search_host(self, query, k: int, nprobe: int = 0):
        """Approximate top-k entirely on the host (numpy BLAS): the IVF
        route of CPU-only deployments and over-budget folders. Touches
        nprobe*cap + spill rows per query and widens only that slice of
        bf16 buckets to f32. Ranking is (score desc, id asc)."""
        cent, buckets, bucket_ids, spill, spill_ids = self._host_arrays()
        nprobe = self.resolve_nprobe(k, nprobe)
        q = np.asarray(query, np.float32).reshape(-1)
        cs = cent.astype(np.float32) @ q
        if nprobe < len(cs):
            probe = np.argpartition(-cs, nprobe - 1)[:nprobe]
        else:
            probe = np.arange(len(cs))
        sub = buckets[probe].reshape(-1, buckets.shape[2])
        ids = bucket_ids[probe].reshape(-1)
        # bf16 buckets: the query rounded to bf16 first, as every route
        # scores it
        qb = as_float32(bf16_bits(q)) if buckets.dtype == np.uint16 else q
        scores = as_float32(sub) @ qb
        if len(spill):
            scores = np.concatenate([scores, as_float32(spill) @ qb])
            ids = np.concatenate([ids, spill_ids])
        valid = ids >= 0
        scores, ids = scores[valid], ids[valid]
        order = np.lexsort((ids, -scores))[:k]
        return scores[order], ids[order].astype(np.int64)

    def _host_arrays(self):
        """Host copies of the five arrays, made once."""
        if not hasattr(self, "_host_cache"):
            self._host_cache = tuple(_to_numpy(a) for a in (
                self.centroids, self.buckets, self.bucket_ids,
                self.spill, self.spill_ids,
            ))
        return self._host_cache

    def resolve_nprobe(self, k: int, nprobe: int = 0) -> int:
        """The auto-nprobe rule: the calibrated value (nlist/4 untuned),
        raised so the probes cover at least 2k rows; capped at nlist."""
        cap = self.buckets.shape[1]
        if not nprobe:
            base = self.tuned_nprobe or max(1, self.nlist // 4)
            nprobe = max(base, -(-2 * k // max(cap, 1)))
        return min(nprobe, self.nlist)

    def search_batch(self, queries, k: int, nprobe: int = 0):
        """Batched approximate top-k: (Q, d) queries -> (Q, kk) f32 scores
        and int64 ids as numpy (kk = min(k, rows the probes cover)). Rows
        the probes cover short are padded with id -1 and score NEG_INF;
        callers drop ids < 0. A host-loaded index searches on the CPU."""
        nprobe = self.resolve_nprobe(k, nprobe)
        k = min(k, self.n)
        q = queries.shape[0]
        if k == 0 or q == 0:
            return np.zeros((q, 0), np.float32), np.zeros((q, 0), np.int64)
        arrays = tuple(_to_tensor(a) for a in (
            self.centroids, self.buckets, self.bucket_ids,
            self.spill, self.spill_ids,
        ))
        qd = torch.as_tensor(queries, dtype=torch.float32).to(arrays[0].device)
        s, i = _ivf_search_batch(*arrays, qd, k, nprobe)
        return s.cpu().numpy(), i.cpu().numpy()


# -- build-time nprobe calibration ---------------------------------------
#
# Recall@k for ANY nprobe is set by the rank each true top-k row's bucket
# takes in the query's centroid ordering, so one exact top-k of a query
# sample plus one centroid-rank lookup give the whole recall(nprobe)
# curve; the calibrated value is the target-recall quantile of those
# ranks (+25% margin). Queries are noise-perturbed corpus rows so they do
# not sit exactly on their own bucket centroids.


def sample_tuning_queries(emb, rng, q_sample: int = 64, noise: float = 0.05):
    """Noise-perturbed corpus rows as calibration queries; (Q, d) f32 unit
    rows on ``emb``'s device (a numpy corpus: the CPU). The rows are the
    reference's draw from ``rng``; the noise comes from a CPU
    ``torch.Generator`` seeded by the next draw, ``rng.integers(2**31)``,
    the draw the reference spends on its JAX key, so later draws from
    ``rng`` stay in step with it."""
    n = emb.shape[0]
    q_sample = min(q_sample, n)
    qidx = rng.choice(n, size=q_sample, replace=False)
    gen = torch.Generator().manual_seed(int(rng.integers(2**31)))
    if isinstance(emb, np.ndarray):
        # host matrix: gather the rows host-side, never the whole corpus
        queries = torch.from_numpy(as_float32(emb[qidx]).copy())
    else:
        queries = emb[torch.from_numpy(qidx).to(emb.device)].float()
    eps = torch.randn(queries.shape, generator=gen, dtype=torch.float32)
    queries = queries + noise * eps.to(queries.device)
    return queries / torch.linalg.norm(queries, dim=1, keepdim=True).clamp(min=1e-12)


def nprobe_from_ranks(cent, assign, is_spilled, queries, exact_i,
                      target: float) -> int:
    """The shared tail of nprobe calibration: bucket ranks of the true
    top-k rows -> the target-recall quantile rank (+25% margin)."""
    nlist = cent.shape[0]
    exact_i = torch.as_tensor(exact_i, device=cent.device).long()
    # spill rows ride as -1: always found, sorted first
    ranks = np.sort(
        _bucket_ranks(cent, assign, is_spilled, queries, exact_i)
        .cpu().numpy().ravel()
    )
    need = max(1, int(np.ceil(target * ranks.size)))
    nprobe = int(ranks[min(need, ranks.size) - 1]) + 1
    return min(nlist, max(1, -(-nprobe * 5 // 4)))


def _tune_nprobe(emb: torch.Tensor, cent: torch.Tensor, assign: torch.Tensor,
                 is_spilled: torch.Tensor, rng, k: int = 48,
                 q_sample: int = 64, target: float = 0.995,
                 noise: float = 0.05) -> int:
    from .search import exact_search_batch

    k = min(k, emb.shape[0])
    queries = sample_tuning_queries(emb, rng, q_sample, noise)
    _, exact_i = exact_search_batch(emb, queries, k)
    return nprobe_from_ranks(cent, assign, is_spilled, queries, exact_i, target)


def _bucket_ranks(cent, assign, is_spilled, queries, exact_i) -> torch.Tensor:
    """For each (query, true top-k row): the rank of the row's bucket in
    the query's centroid ordering (ties by lower list); -1 for spill rows
    (always scanned)."""
    q, nlist = queries.shape[0], cent.shape[0]
    cscores = queries.to(cent.device).float() @ cent.T
    order = torch.argsort(-cscores, dim=1, stable=True)
    rank = torch.empty((q, nlist), dtype=torch.int64, device=cent.device)
    rank.scatter_(1, order, torch.arange(nlist, device=cent.device).expand(q, nlist))
    hit_rank = rank.gather(1, assign[exact_i])
    return torch.where(is_spilled[exact_i], -1, hit_rank)


def _ivf_search_batch(centroids, buckets, bucket_ids, spill, spill_ids,
                      queries: torch.Tensor, k: int, nprobe: int):
    """(Q, d) queries -> (Q, kk) f32 scores and int64 ids, in chunks of
    _IVF_BATCH_CHUNK queries (see there)."""
    outs = [
        _ivf_search(centroids, buckets, bucket_ids, spill, spill_ids,
                    queries[start : start + _IVF_BATCH_CHUNK], k, nprobe)
        for start in range(0, queries.shape[0], _IVF_BATCH_CHUNK)
    ]
    return torch.cat([s for s, _ in outs]), torch.cat([i for _, i in outs])


def _ivf_search(centroids, buckets, bucket_ids, spill, spill_ids,
                queries: torch.Tensor, k: int, nprobe: int):
    """One chunk of (C, d) f32 queries: the top-nprobe lists of each
    (ties by lower list), their buckets gathered and scored in f32, pads
    masked, the spill appended, then the (score desc, id asc) top-k."""
    c = queries.shape[0]
    _, probe = stable_topk(queries @ centroids.T, nprobe)  # (C, nprobe)
    sub = buckets[probe].reshape(c, -1, buckets.shape[2])  # (C, P*cap, d)
    flat_ids = bucket_ids[probe].reshape(c, -1).long()
    # the query rounded to the bucket dtype, as every exact route and the
    # host probe score it; bf16 x bf16 -> f32 products
    qd = queries.to(buckets.dtype)
    scores = matmul_f32(sub, qd[:, :, None])[:, :, 0]
    if spill.shape[0]:
        sp_scores = matmul_f32(spill, qd.T).T  # (C, S)
        scores = torch.cat([scores, sp_scores], dim=1)
        flat_ids = torch.cat([flat_ids, spill_ids.long().expand(c, -1)], dim=1)
    scores = torch.where(flat_ids >= 0, scores, NEG_INF)
    kk = min(k, scores.shape[1])
    return sort_by_score_then_index(scores, flat_ids, kk)
