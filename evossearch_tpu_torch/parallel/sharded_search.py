"""Corpus-sharded exact top-k search — PyTorch counterpart of
``evossearch_tpu/parallel/sharded_search.py``.

The corpus is cut into ``S`` row blocks of ``rows = ceil(n / S)`` over a
mesh of ``S`` devices, the last block ragged; a row's global id is
``shard * rows + local``. Each block holds only its valid rows
(``counts``), so a pad row never exists to enter a result.

    per block:  the port's own single-device route on the block's device:
                the candidate kernels (``index.search.pallas_search_batch``,
                B1 or B2 by ``use_tree_kernel``, uncertified rows re-run
                on the dense path) for blocks of CERT_MIN_SHARD_ROWS rows
                and up, the dense exact path below that; on the CPU both
                run the kernels' plain versions
    merge:      each block's <= k candidates with their global ids, in
                block order, on the host; the top k under (score desc,
                global id asc)

Every block returns its exact top-k under the same contract, so the merge
returns the exact global top-k: the same rows as the single-device path,
with each row's score as the block's route computes it.

Difference from the JAX package: its per-shard body is one dense product
with ``approx_max_k`` and two certificates (or a blocked exact selection),
all-gathered over the mesh; here each block runs the kernels the port
already has, and the merge is on the host. Both give the exact top-k.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .mesh import Mesh, corpus_mesh

# Rows per block from which a block takes the candidate kernels, as the
# single-device route does from 2^18 rows (index/search._FAST_PATH_MIN_ROWS).
# Module-level so tests can lower it to reach the kernels' plain versions
# and their fallbacks on small CPU corpora.
CERT_MIN_SHARD_ROWS = 1 << 18

_UPLOAD_ROWS = 1 << 18  # host rows per host->device copy


def block_counts(n: int, n_blocks: int) -> tuple[int, np.ndarray]:
    """(rows per block, valid rows of each block): the JAX package's row
    blocks, ``rows = ceil(n / S)`` (at least 1)."""
    rows = -(-max(n, 1) // n_blocks)
    counts = np.minimum(np.maximum(n - rows * np.arange(n_blocks), 0), rows)
    return rows, counts.astype(np.int64)


def _as_tensor(rows: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host rows (float32, or bfloat16 bits as uint16) as a tensor on
    ``device``, copied (a store's mmap is read-only)."""
    t = torch.from_numpy(np.array(rows))
    t = t.view(torch.bfloat16) if rows.dtype == np.uint16 else t.float()
    return t.to(device)


def reader_rows(reader, lo: int, hi: int, device: torch.device) -> torch.Tensor:
    """Global rows [lo, hi) of a shard store as one tensor on ``device``,
    read straight off the store's mmap shards in chunks of _UPLOAD_ROWS:
    no host copy of the whole range is made."""
    bf16 = reader.dtype_name == "bfloat16"
    out = torch.empty((hi - lo, reader.dim),
                      dtype=torch.bfloat16 if bf16 else torch.float32,
                      device=device)
    off = 0
    for shard in reader.shard_arrays():
        a, b = max(lo, off), min(hi, off + shard.shape[0])
        for s in range(a, b, _UPLOAD_ROWS):
            e = min(s + _UPLOAD_ROWS, b)
            out[s - lo : e - lo] = _as_tensor(shard[s - off : e - off], device)
        off += shard.shape[0]
    return out


def merge_candidates(cand_s: np.ndarray, cand_i: np.ndarray, k: int):
    """(Q, C) candidate scores and global ids -> the top k of each row
    under (score desc, id asc)."""
    order = np.lexsort((cand_i, -cand_s), axis=1)[:, :k]
    return (np.take_along_axis(cand_s, order, axis=1),
            np.take_along_axis(cand_i, order, axis=1))


@dataclass
class ShardedIndex:
    """An embedding corpus row-sharded across a mesh of devices."""

    blocks: list  # per mesh device: (counts[s], d) rows on that device
    counts: np.ndarray  # (S,) valid rows per block
    rows: int  # rows per block (the last may hold fewer)
    n: int
    mesh: Mesh

    @classmethod
    def from_reader(cls, reader, mesh: Mesh | None = None,
                    n_devices: int = 0) -> "ShardedIndex":
        """Place a shard-store corpus onto the mesh: each block is read
        straight off the store's mmap shards onto its own device, so no
        host copy of the whole corpus is made and no device holds more
        than its block."""
        mesh = mesh or corpus_mesh(n_devices)
        rows, counts = block_counts(reader.count, mesh.size)
        blocks = [
            reader_rows(reader, s * rows, s * rows + int(c), dev)
            for s, (c, dev) in enumerate(zip(counts, mesh.devices))
        ]
        return cls(blocks=blocks, counts=counts, rows=rows, n=reader.count,
                   mesh=mesh)

    @classmethod
    def from_matrix(cls, matrix, mesh: Mesh | None = None,
                    n_devices: int = 0) -> "ShardedIndex":
        """Place an (N, d) matrix onto the mesh: host numpy (float32, or
        bfloat16 bits as uint16) or a tensor."""
        mesh = mesh or corpus_mesh(n_devices)
        n = matrix.shape[0]
        rows, counts = block_counts(n, mesh.size)
        blocks = []
        for s, (c, dev) in enumerate(zip(counts, mesh.devices)):
            part = matrix[s * rows : s * rows + int(c)]
            blocks.append(part.to(dev).contiguous() if isinstance(part, torch.Tensor)
                          else _as_tensor(part, dev))
        return cls(blocks=blocks, counts=counts, rows=rows, n=n, mesh=mesh)

    def search(self, query, k: int) -> tuple[np.ndarray, np.ndarray]:
        """Exact top-k of one (d,) query; FAISS-shaped result."""
        scores, idx = self.search_batch(query[None, :], k)
        return scores[0], idx[0]

    def search_batch(self, queries, k: int) -> tuple[np.ndarray, np.ndarray]:
        """Batched exact top-k: (Q, d) queries (numpy or a tensor) ->
        (Q, k) float32 scores and int64 global ids, numpy."""
        from ..index.search import exact_search_batch, pallas_search_batch

        nq = queries.shape[0]
        k = min(k, self.n)
        if k == 0:
            return np.zeros((nq, 0), np.float32), np.zeros((nq, 0), np.int64)
        route = (pallas_search_batch if self.rows >= CERT_MIN_SHARD_ROWS
                 else exact_search_batch)
        cand_s, cand_i = [], []
        for s, blk in enumerate(self.blocks):
            if blk.shape[0]:  # a corpus of fewer rows than blocks leaves some empty
                bs, bi = route(blk, queries, k)
                cand_s.append(bs)
                cand_i.append(bi + s * self.rows)
        return merge_candidates(np.concatenate(cand_s, axis=1),
                                np.concatenate(cand_i, axis=1), k)
