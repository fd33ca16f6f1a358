"""Mesh-sharded SQ8: the certified int8 capacity tier across a mesh —
PyTorch counterpart of ``evossearch_tpu/parallel/sharded_sq8.py``.

The int8 sidecar (``index/sq8.py``) is cut into the same row blocks as
``ShardedIndex``, ``rows = ceil(n / S)``, each padded to ``rows`` with
scale 0 and radd -inf, so a pad row's bound is -inf and it is never
fetched. Per block, on the block's device: the bound sweep
(``ops.sq8_candidates``, CUDA kernel B3) computes a rigorous upper bound
on every row's score, an exact ``torch.topk`` fetches the block's top
``fetch`` bounds, and the counting certificate says whether the fetched
set is the whole "bound >= mf_s" set (``index.sq8._sq8_select``). The
merge, on the mesh's first device, takes an EXACT global top-``fetch`` of
the gathered bounds; the host reranks only those rows straight off the
mmap store and certifies, with m the k-th reranked score:

    m >= mf_s  for every block s    (cnt_all, m >= mf_max)
    m >= mf_g                        (candidates the global merge dropped)
    max_s m3max_s < m                (rows the kernel's tree dropped)

A row left out therefore scores at most its bound < m and cannot reach
the top-k: certified queries return the exact global top-k under the
(score desc, index asc) contract, the others rerun on the host scan, as
in the one-device tier.

Difference from the JAX package: ids come back as int64, without the f32
hi/lo packing its single device transfer needed.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.topk import LANES, NEG_INF, TREE_CLASSES, stable_topk
from .mesh import Mesh
from .sharded_search import block_counts


class SQ8ShardedIndex:
    """A one-device ``SQ8Index`` row-sharded over a mesh.

    Wraps the base index: sidecar persistence, the host rerank and the
    score and tie contract are ``index/sq8.py``'s; only the placement and
    the device half differ."""

    def __init__(self, base, mesh: Mesh):
        self.base = base
        self.mesh = mesh
        self.n, self.dim = base.n, base.dim
        self.fetch = base.fetch
        self.tile_rows = base.tile_rows
        self.rows_per_shard, self.counts = block_counts(self.n, mesh.size)
        grid = -(-self.rows_per_shard // self.tile_rows)
        self._shard_c_total = grid * 2 * TREE_CLASSES
        self._e8_d: list | None = None
        self._scal2_d: list | None = None

    def ensure_device(self) -> None:
        """Materialize the sidecar block by block, each read straight off
        the sidecar mmap onto its device (pad rows made there): no host
        copy of the whole sidecar."""
        from ..index.sq8 import _UPLOAD_ROWS

        if self._e8_d is not None:
            return
        rows, d = self.rows_per_shard, self.dim
        e8s, scal2s = [], []
        for s, (c, dev) in enumerate(zip(self.counts, self.mesh.devices)):
            lo, c = s * rows, int(c)
            e8 = torch.zeros((rows, d), dtype=torch.int8, device=dev)
            scal2 = torch.zeros((2, rows), dtype=torch.float32, device=dev)
            scal2[1] = -np.inf  # pad rows: scale 0, radd -inf: never fetched
            for a in range(0, c, _UPLOAD_ROWS):
                b = min(a + _UPLOAD_ROWS, c)
                e8[a:b] = torch.from_numpy(np.array(self.base.e8[lo + a : lo + b])).to(dev)
            scal2[:, :c] = torch.from_numpy(
                np.array(self.base.scal2[:, lo : lo + c], np.float32)).to(dev)
            e8s.append(e8)
            scal2s.append(scal2)
        self._e8_d, self._scal2_d = e8s, scal2s

    def search_batch(self, queries: np.ndarray, k: int):
        """(Q, d) -> exact (scores (Q, k) f32, ids (Q, k) int64) under the
        global (score desc, index asc) tie contract: the same ranking as
        the one-device SQ8 tier and the host scan."""
        from ..index.search import query_row_bucket
        from ..index.sq8 import _sq8_select, rerank_and_certify

        queries = np.asarray(queries, np.float32)
        nq = queries.shape[0]
        k = min(k, self.n)
        if k == 0 or nq == 0:
            return (np.zeros((nq, k), np.float32),
                    np.zeros((nq, k), np.int64))
        if nq > LANES:
            # the kernel takes at most LANES queries per pass
            parts = [
                self.search_batch(queries[i : i + LANES], k)
                for i in range(0, nq, LANES)
            ]
            return (np.concatenate([p[0] for p in parts]),
                    np.concatenate([p[1] for p in parts]))
        self.ensure_device()
        fetch = min(max(self.fetch, k + 32), self._shard_c_total)
        full_fetch = fetch == self._shard_c_total
        # the serving path's query-row buckets (extra rows repeat row 0),
        # as the one-device tier pads them
        pad = query_row_bucket(nq)
        qpad = queries
        if pad > nq:
            qpad = np.concatenate(
                [queries, np.broadcast_to(queries[:1], (pad - nq, self.dim))])
        q_host = torch.from_numpy(np.ascontiguousarray(qpad))
        first = self.mesh.devices[0]
        fbs, fids, oks, mfs, m3s = [], [], [], [], []
        for s, dev in enumerate(self.mesh.devices):
            fb, fid, cnt_ok, m3max = _sq8_select(
                self._e8_d[s], self._scal2_d[s], q_host.to(dev), fetch,
                self.tile_rows,
            )
            fbs.append(fb.to(first))
            fids.append((fid + s * self.rows_per_shard).to(first))
            oks.append(cnt_ok.to(first))
            mfs.append(fb[:, -1].to(first))
            m3s.append(m3max.to(first))
        # EXACT top-`fetch` of the gathered bounds, ties to the lower
        # position as in the JAX merge: the host rerank reads about
        # `fetch` rows per query however many blocks there are
        gb, gpos = stable_topk(torch.cat(fbs, dim=1), fetch)
        gi = torch.cat(fids, dim=1).gather(1, gpos)
        cnt_all = torch.stack(oks).all(dim=0)
        # a block whose fetch covered its whole candidate set has mf at the
        # sentinel, a bound every m satisfies
        mf_max = torch.stack(mfs).amax(dim=0)
        m3_g = torch.stack(m3s).amax(dim=0)
        gb, ids, cnt_all, mf_max, m3_g = (
            t[:nq].cpu().numpy() for t in (gb, gi, cnt_all, mf_max, m3_g))
        mf_g = gb[:, -1]
        # the kernel's tail-masked cells carry the finite sentinel NEG_INF
        # with aliased ids, and pad rows -inf: without this filter a
        # full-fetch merge over a small corpus certifies duplicate ids
        finite = np.isfinite(gb) & (gb > np.float32(NEG_INF) / 2)
        ids = np.where(finite & (ids < self.n), ids, 0)
        n_shards = self.mesh.size

        def cert(qi: int, m: float) -> bool:
            # three drop sites, three terms: rows a block never fetched
            # (cnt_ok and m >= mf_s, both vacuous when the fetch covered
            # the block's whole candidate set), candidates the global merge
            # dropped (m >= mf_g; only with more than one block), and rows
            # the kernel's tree dropped (m3 < m)
            return bool(
                m3_g[qi] < m
                and (n_shards == 1 or m >= mf_g[qi])
                and (full_fetch or (cnt_all[qi] and m >= mf_max[qi]))
            )

        return rerank_and_certify(self.base, queries, ids, finite, k, cert)
