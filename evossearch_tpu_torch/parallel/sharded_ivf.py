"""Mesh-sharded IVF — PyTorch counterpart of
``evossearch_tpu/parallel/sharded_ivf.py``.

  build   global spherical-k-means centroids from a corpus SAMPLE, on the
          mesh's first device; then per row block (``rows = ceil(n / S)``,
          as ``ShardedIndex``): the block's rows assigned to the global
          centroids on its device and laid out in numpy as dense
          (nlist, cap, d) buckets plus an exact-scanned spill, the layout
          of ``index.ivf.IVFIndex``. Every block shares one ``cap``, and
          each spill is padded to the largest block's.
  query   the probe list depends only on the query and the centroids, so
          every block probes the same nprobe buckets of its own rows
          (``index.ivf._ivf_search_batch`` on the block's device); the
          blocks' candidates, with global ids, merge on the first device
          under (score desc, global id asc).

The union of the blocks' buckets for a centroid is the global bucket for
that centroid, so a probe finds the same rows as a one-device IVF would;
spill rows are always scanned. At nprobe = nlist every row is scanned and
the result is the exact top-k, which the build's nprobe calibration uses
as its reference.

``ivf_mesh{S}.npz`` sidecars are byte-compatible with the JAX package's in
both directions: the blocks stacked along the first axis, bf16 as uint16
bit patterns, and ``meta`` = [n, nlist, S, tuned_nprobe, is_bf16].

Differences from the JAX package: ids come back as int64 directly, and
``build`` agrees with the JAX package's by statistics only (its k-means
and calibration noise are ``index.ivf``'s); searches of one sidecar agree
id for id.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..index.ivf import (
    _assign, _kmeans, _ivf_search_batch, _to_numpy, _to_tensor,
    nprobe_from_ranks, sample_tuning_queries,
)
from ..index.store import as_float32, bf16_bits
from ..ops.topk import sort_by_score_then_index
from .mesh import Mesh, corpus_mesh
from .sharded_search import block_counts


@dataclass
class ShardedIVFIndex:
    centroids: torch.Tensor  # (nlist, d) f32 on the mesh's first device
    buckets: list  # per block: (nlist, cap, d) at the store dtype
    bucket_ids: list  # per block: (nlist, cap) int32 GLOBAL row ids, -1 pad
    spill: list  # per block: (spill_cap, d), exact-scanned
    spill_ids: list  # per block: (spill_cap,) int32 global ids, -1 pad
    n: int
    nlist: int
    mesh: Mesh
    tuned_nprobe: int = 0
    # the centroids on each block's device (one tensor where devices repeat)
    _block_cent: list = field(init=False, repr=False, compare=False)

    def __post_init__(self):
        self._block_cent = [self.centroids.to(dev) for dev in self.mesh.devices]

    @classmethod
    def build(
        cls, matrix, mesh: Mesh | None = None, n_devices: int = 0,
        nlist: int = 0, iters: int = 10, bucket_factor: float = 2.0,
        seed: int = 0, tune_target: float | None = 0.995,
        train_rows: int = 1 << 17, pre_normalized: bool = True,
    ) -> "ShardedIVFIndex":
        """Build from an (N, d) matrix on the host (float32, or bfloat16
        bits as uint16; a tensor is copied to the host first, any other
        dtype becomes float32). Buckets and spill keep the store dtype.

        Centroids train on a ``train_rows`` sample; each block's
        assignment runs on its device; the data-dependent bucket and spill
        split is numpy. ``pre_normalized=True`` (store rows are unit norm
        at encode time) skips a host normalize pass. nprobe is calibrated
        against this index probed at nprobe = nlist, which is the exact
        top-k, so no other exact scan of the corpus is needed."""
        mesh = mesh or corpus_mesh(n_devices)
        n_dev = mesh.size
        matrix = _to_numpy(matrix)
        if matrix.dtype not in (np.float32, np.uint16):
            matrix = matrix.astype(np.float32)
        n, d = matrix.shape
        if n == 0:
            raise ValueError("cannot build an IVF over an empty corpus")
        if not pre_normalized:
            bf16 = matrix.dtype == np.uint16
            matrix = matrix.copy()
            for lo in range(0, n, 1 << 15):
                blk = as_float32(matrix[lo : lo + (1 << 15)])
                blk = blk / np.maximum(np.linalg.norm(blk, axis=1, keepdims=True), 1e-12)
                matrix[lo : lo + (1 << 15)] = bf16_bits(blk) if bf16 else blk
        rng = np.random.default_rng(seed)
        nlist = min(nlist or max(1, int(np.sqrt(n))), n)
        first = mesh.devices[0]

        # global centroids from a sample
        ts = min(n, max(train_rows, nlist))
        sample = matrix[rng.choice(n, size=ts, replace=False)]
        init = as_float32(sample[rng.choice(ts, size=nlist, replace=False)])
        cent = _kmeans(_to_tensor(sample, first),
                       torch.from_numpy(np.ascontiguousarray(init)).to(first), iters)
        del sample

        rps, _ = block_counts(n, n_dev)  # global id = block * rps + local
        cap = max(1, int(np.ceil(rps / nlist * bucket_factor)))
        buckets_h = np.zeros((n_dev, nlist, cap, d), matrix.dtype)
        ids_h = np.full((n_dev, nlist, cap), -1, np.int32)
        assigns: list[np.ndarray] = []
        spills: list[tuple[np.ndarray, np.ndarray]] = []
        for s, dev in enumerate(mesh.devices):
            lo = s * rps
            local = matrix[lo : lo + rps]
            ln = local.shape[0]
            if ln == 0:
                assigns.append(np.zeros((0,), np.int64))
                spills.append((np.zeros((0, d), matrix.dtype), np.zeros((0,), np.int32)))
                continue
            a = _assign(_to_tensor(np.array(local), dev), cent.to(dev)).cpu().numpy()
            assigns.append(a)
            order = np.argsort(a, kind="stable")
            sa = a[order]
            starts = np.searchsorted(sa, np.arange(nlist))
            pos = np.arange(ln) - starts[sa]
            in_b = pos < cap
            rows = order[in_b]
            buckets_h[s, sa[in_b], pos[in_b]] = local[rows]
            ids_h[s, sa[in_b], pos[in_b]] = rows.astype(np.int32) + lo
            sp_rows = order[~in_b]
            spills.append((local[sp_rows], sp_rows.astype(np.int32) + lo))
        spill_cap = max(1, max(sp[0].shape[0] for sp in spills))
        spill_h = np.zeros((n_dev, spill_cap, d), matrix.dtype)
        spill_ids_h = np.full((n_dev, spill_cap), -1, np.int32)
        for s, (vecs, ids) in enumerate(spills):
            spill_h[s, : len(ids)] = vecs
            spill_ids_h[s, : len(ids)] = ids

        idx = cls._from_host(cent.cpu().numpy(), buckets_h, ids_h, spill_h,
                             spill_ids_h, n=n, nlist=nlist, mesh=mesh)
        if tune_target is not None and nlist > 1:
            queries = sample_tuning_queries(matrix, rng)
            _, exact_i = idx.search_batch(queries, k=min(48, n), nprobe=nlist)
            spilled = np.zeros((n,), bool)
            for _, ids in spills:
                spilled[ids] = True
            idx.tuned_nprobe = nprobe_from_ranks(
                cent, torch.from_numpy(np.concatenate(assigns)).to(first),
                torch.from_numpy(spilled).to(first), queries, exact_i,
                tune_target,
            )
        return idx

    @classmethod
    def _from_host(cls, centroids, buckets, bucket_ids, spill, spill_ids, *,
                   n: int, nlist: int, mesh: Mesh, tuned_nprobe: int = 0):
        """Host arrays with the blocks stacked on a leading axis of size S
        (bf16 as uint16 bits), each block placed on its device."""
        devs = mesh.devices
        return cls(
            centroids=torch.from_numpy(np.asarray(centroids, np.float32)).to(devs[0]),
            buckets=[_to_tensor(np.ascontiguousarray(b), dev) for b, dev in zip(buckets, devs)],
            bucket_ids=[_to_tensor(np.ascontiguousarray(b), dev)
                        for b, dev in zip(bucket_ids, devs)],
            spill=[_to_tensor(np.ascontiguousarray(b), dev) for b, dev in zip(spill, devs)],
            spill_ids=[_to_tensor(np.ascontiguousarray(b), dev)
                       for b, dev in zip(spill_ids, devs)],
            n=n, nlist=nlist, mesh=mesh, tuned_nprobe=tuned_nprobe,
        )

    def resolve_nprobe(self, k: int, nprobe: int = 0) -> int:
        """IVFIndex's auto rule: the calibrated value (nlist/4 untuned),
        raised so the probes cover at least 2k rows; capped at nlist."""
        cap = self.buckets[0].shape[1]
        if not nprobe:
            base = self.tuned_nprobe or max(1, self.nlist // 4)
            nprobe = max(base, -(-2 * k // max(cap, 1)))
        return min(nprobe, self.nlist)

    def search_batch(self, queries, k: int, nprobe: int = 0):
        """Batched approximate top-k: (Q, d) -> (Q, kout) f32 scores and
        int64 global ids, numpy. Rows the probes cover short of kout pad
        with score NEG_INF and id -1; callers drop ids < 0."""
        nprobe = self.resolve_nprobe(k, nprobe)
        k = min(k, self.n)
        nq = queries.shape[0]
        if k == 0 or nq == 0:
            return np.zeros((nq, 0), np.float32), np.zeros((nq, 0), np.int64)
        q = torch.as_tensor(queries, dtype=torch.float32)
        first = self.mesh.devices[0]
        cand_s, cand_i = [], []
        for s, dev in enumerate(self.mesh.devices):
            bs, bi = _ivf_search_batch(
                self._block_cent[s], self.buckets[s], self.bucket_ids[s],
                self.spill[s], self.spill_ids[s], q.to(dev), k, nprobe,
            )
            cand_s.append(bs.to(first))
            cand_i.append(bi.to(first))
        cs, ci = torch.cat(cand_s, dim=1), torch.cat(cand_i, dim=1)
        s, i = sort_by_score_then_index(cs, ci, min(k, cs.shape[1]))
        return s.cpu().numpy(), i.cpu().numpy()

    def search(self, query, k: int, nprobe: int = 0):
        """Approximate top-k of one (d,) query; FAISS-shaped, without the
        pad rows."""
        q = torch.as_tensor(query, dtype=torch.float32).reshape(1, -1)
        s, i = self.search_batch(q, k, nprobe)
        valid = i[0] >= 0
        return s[0][valid], i[0][valid]

    def save(self, path) -> None:
        """Persist the centroids and the stacked block layout in the JAX
        package's format. The layout depends on the mesh SIZE, which is
        recorded and checked at load."""
        buckets = np.concatenate([_to_numpy(b) for b in self.buckets])
        spill = np.concatenate([_to_numpy(b) for b in self.spill])
        np.savez(
            path,
            centroids=_to_numpy(self.centroids),
            buckets=buckets,
            bucket_ids=np.concatenate([_to_numpy(b) for b in self.bucket_ids]),
            spill=spill,
            spill_ids=np.concatenate([_to_numpy(b) for b in self.spill_ids]),
            meta=np.asarray(
                [self.n, self.nlist, self.mesh.size, self.tuned_nprobe,
                 int(buckets.dtype == np.uint16)],
                np.int64,
            ),
        )

    @classmethod
    def load(cls, path, mesh: Mesh | None = None) -> "ShardedIVFIndex | None":
        """Load onto ``mesh``, which must have the saved mesh's SIZE (the
        block layout is size-specific). None on any anomaly, a size
        mismatch included: callers rebuild."""
        mesh = mesh or corpus_mesh()
        try:
            with np.load(path, allow_pickle=False) as data:
                n, nlist, n_dev, tuned, is_bf16 = (int(v) for v in data["meta"])
                if n_dev != mesh.size:
                    return None
                arrays = {key: data[key] for key in (
                    "centroids", "buckets", "bucket_ids", "spill", "spill_ids")}
            for key in ("buckets", "spill"):
                if bool(is_bf16) != (arrays[key].dtype == np.uint16):
                    return None
            stacked = {
                key: arrays[key].reshape((n_dev, -1) + arrays[key].shape[1:])
                for key in ("buckets", "bucket_ids", "spill", "spill_ids")
            }
            return cls._from_host(arrays["centroids"], **stacked, n=n,
                                  nlist=nlist, mesh=mesh, tuned_nprobe=tuned)
        except Exception:
            return None
