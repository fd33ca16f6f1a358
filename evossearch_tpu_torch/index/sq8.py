"""SQ8: certified-exact search over an int8-quantized corpus sidecar —
PyTorch counterpart of ``evossearch_tpu/index/sq8.py``.

The capacity tier. A folder whose corpus exceeds the device budget keeps
an int8 sidecar (half the bytes of bf16, a quarter of f32) on the device
instead, and still returns EXACT results:

  1. device: one pass of the bound-sweep kernel (``ops.topk.sq8_candidates``,
     CUDA kernel B3) computes a rigorous UPPER BOUND on every row's true
     score and keeps each residue class's top-2 bounds and third-best
     bound, exactly like the exact tree kernel but with bounds in place of
     scores;
  2. device: an exact ``torch.topk`` fetches the top-``fetch`` bounds,
     with the reference's counting certificate (the fetched set provably
     equals the "bound >= mf" set, mf = lowest fetched bound);
  3. host: the fetched rows are gathered from the mmap store and reranked
     with the SAME score function as the host exact scan
     (index.search.exact_search_host*), then certified: with m = the
     k-th reranked score, ``m >= mf`` proves every row whose bound could
     reach the top-k was fetched, and ``max third class bound < m`` proves
     the kernel dropped nothing that mattered. Certified rows are the
     exact top-k under the (score desc, index asc) tie contract;
     uncertified rows (mass ties, flat score distributions) rerun through
     the host batch scan.

Sidecar files (``sq8.bin``, ``sq8_scales.bin``, ``sq8.json``) are
byte-compatible with the JAX package's in both directions.

Differences from the JAX package: the fetch is an exact ``torch.topk`` in
place of ``approx_max_k`` (the certificate is kept as it is), and ids come
back as int64 tensors, without the f32 hi/lo packing that the reference
used to return everything in one device transfer.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from ..ops.topk import LANES, NEG_INF, SQ8_TILE_ROWS, TREE_CLASSES, sq8_candidates
from .store import as_float32, bf16_bits

C_BF16 = 2.0 ** -9  # half-ulp relative error of round-to-nearest bf16

_SQ8_VERSION = 1
_F_BIN = "sq8.bin"
_F_SCALES = "sq8_scales.bin"
_F_META = "sq8.json"

# Fetch depth. The certificate needs the k-th EXACT score to beat the
# ``fetch``-th highest BOUND; bounds sit ~radd (~1e-2 for unit CLIP rows)
# above their scores, so the fetch must reach far enough down the score
# tail to clear that gap. Overridable via EVOSSEARCH_SQ8_FETCH.
DEFAULT_FETCH = 512

_UPLOAD_ROWS = 1 << 18  # sidecar rows per host->device copy


def quantize_rows(rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-row symmetric int8 quantization + rigorous bound scalars.

    rows: (n, d) float32 (bf16 stores widen first — widening is exact).
    Returns (e8 (n, d) int8, scal2 (2, n) f32 = [scale; radd]).

    Bound derivation, per row ``a`` and query ``q`` (q~ = bf16(q), which
    is ALSO the query the kernel and the bf16 host scan use):

        s = <a, q> = scale*<e8, q> + <r, q>,     r = a - scale*e8
        kernel computes  dot = f32-accum <e8, q~>  (exact products:
          int8 and bf16 both carry <= 8-bit mantissas)
        |<r, q>|  and  |<r, q~>|   <= ||r|| * ||q|| * (1 + C_BF16)
        scale*|<e8, q - q~>|       <= scale*||e8|| * C_BF16 * ||q||
        f32 accumulation error     <= scale*||e8|| * d * 2^-24 * ||q||
          (the serial bound, which holds for any order of the d additions,
          doubled to cover the host rerank BLAS accumulation too)

    so  u = dot*scale + radd*||q||  >=  the score ANY of the exact paths
    computes for this row (raw-f32 query or bf16-quantized query). The
    1.05 / 1e-5 / 1e-7 inflations absorb the rounding of the bound's own
    products and sum; rigor is property-tested in tests/test_torch_sq8.py.
    """
    a = np.ascontiguousarray(rows, np.float32)
    n, d = a.shape
    m = np.abs(a).max(axis=1)
    scale = np.where(m > 0, m / 127.0, 1.0).astype(np.float32)
    # one reused f32 buffer, in-place ops throughout; the f32 norm
    # rounding (~1e-7 relative) is absorbed by the (1+4e-3) and 1.05
    # inflations
    q = np.empty_like(a)
    np.divide(a, scale[:, None], out=q)   # true divide: e8 must match
    np.rint(q, out=q)                     # quantize_rows_device exactly
    np.minimum(q, np.float32(127.0), out=q)
    np.maximum(q, np.float32(-127.0), out=q)
    e8 = q.astype(np.int8)
    anorm = scale * np.sqrt(
        (q * q).sum(axis=1, dtype=np.float64)
    ).astype(np.float32)
    q *= scale[:, None]                   # q := scale*ef
    np.subtract(a, q, out=q)              # q := residual r
    rnorm = np.sqrt((q * q).sum(axis=1, dtype=np.float64)).astype(np.float32)
    radd = (
        rnorm * (1 + 4e-3)
        + anorm * (C_BF16 + 2.0 * d * 2.0 ** -24) * 1.05
    ) * (1 + 1e-5) + 1e-7
    scal2 = np.stack([scale, radd.astype(np.float32)])
    return e8, np.ascontiguousarray(scal2, np.float32)


def quantize_rows_device(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``quantize_rows`` in torch on ``a``'s device (validation; sidecars
    build host-side from the mmap store). Same e8 as the host version
    (true division, round half to even, clip); same bound formula, with
    the residual norms in f32 (the host path sums in f64), whose rounding
    (~anorm * 2^-24) the rnorm inflation absorbs."""
    a = a.to(torch.float32)
    d = a.shape[1]
    m = a.abs().amax(dim=1)
    scale = torch.where(m > 0, m / 127.0, torch.ones_like(m))
    e8 = torch.round(a / scale[:, None]).clamp_(-127, 127).to(torch.int8)
    ef = e8.to(torch.float32)
    r = a - scale[:, None] * ef
    rnorm = torch.sqrt((r * r).sum(dim=1))
    anorm = scale * torch.sqrt((ef * ef).sum(dim=1))
    radd = (
        rnorm * (1 + 4e-3)
        + anorm * (C_BF16 + 2.0 * d * 2.0 ** -24) * 1.05
    ) * (1 + 1e-5) + 1e-7
    return e8, torch.stack([scale, radd])


def _sq8_select(e8: torch.Tensor, scal2: torch.Tensor, queries: torch.Tensor,
                fetch: int, tile_rows: int):
    """Device half of the SQ8 search: bound sweep + exact top-``fetch``
    of the candidate bounds + the counting certificate. Returns device
    tensors (fb (Q, fetch) f32 bounds, fid (Q, fetch) int64 rows,
    cnt_ok (Q,) bool, m3max (Q,) f32)."""
    queries = queries.to(torch.float32)
    qn = torch.linalg.norm(queries, dim=1)  # of the f32 queries
    cand_s, cand_i, m3 = sq8_candidates(e8, scal2, queries, qn, tile_rows)
    m3max = m3.amax(dim=1)
    fb, fpos = torch.topk(cand_s, fetch, dim=1)
    fid = cand_i.gather(1, fpos).to(torch.int64)
    mf = fb[:, -1:]
    ge_all = (cand_s >= mf).sum(dim=1)
    ge_got = (fb >= mf).sum(dim=1)
    return fb, fid, ge_all == ge_got, m3max


def rerank_and_certify(index, queries: np.ndarray, ids: np.ndarray,
                       finite: np.ndarray, k: int, cert):
    """Host half of the SQ8 search: gather the candidate rows off the
    mmap store, rerank every query with ONE BLAS GEMM, rank under the
    (score desc, index asc) tie contract, and rerun queries whose
    certificate fails through the host exact scan. ``cert(qi, m)``
    decides, given the k-th reranked score m, whether query qi's result is
    proven exact."""
    nq = queries.shape[0]
    uniq = np.unique(ids)
    rows = index._gather_rows(uniq)
    rq = index._rerank_queries(queries)
    rs = rows @ rq.T  # (m, Q): one BLAS GEMM reranks every query
    pos = np.searchsorted(uniq, ids)

    out_s = np.empty((nq, k), np.float32)
    out_i = np.empty((nq, k), np.int64)
    fail: list[int] = []
    for qi in range(nq):
        s = np.where(finite[qi], rs[pos[qi], qi], -np.inf)
        order = np.lexsort((ids[qi], -s))[:k]
        out_s[qi] = s[order]
        out_i[qi] = ids[qi][order]
        m = out_s[qi, k - 1]
        if not (np.isfinite(m) and cert(qi, m)):
            fail.append(qi)
    if fail:
        if index.counters is not None:
            index.counters.add("sq8_fallback_queries", len(fail))
        from .search import exact_search_host_reader_batch

        fs, fi = exact_search_host_reader_batch(
            index.reader, queries[fail], k
        )
        out_s[fail] = fs
        out_i[fail] = fi
    return out_s, out_i


class SQ8Index:
    """Int8 sidecar + certified search over a shard-store reader.

    Build/persist is pure host numpy (chunked over the mmap shards — an
    over-budget corpus by definition can't ride through the device);
    search holds only the int8 matrix + (2, n) scalars on the device.
    """

    def __init__(self, e8: np.ndarray, scal2: np.ndarray, reader,
                 fetch: int = DEFAULT_FETCH, tile_rows: int | None = None):
        self.e8 = e8            # (n, d) int8 (mmap or ndarray)
        self.scal2 = scal2      # (2, n) f32
        self.reader = reader
        self.n, self.dim = e8.shape
        self.fetch = fetch
        # The class certificate needs many (tile, residue-class) cells to
        # spread the top-k over (cells = 128 * n / tile); the default tile
        # is sized for the multi-million-row corpora this tier exists for,
        # tests shrink it.
        self.tile_rows = tile_rows or SQ8_TILE_ROWS
        self._e8_d: torch.Tensor | None = None
        self._scal2_d: torch.Tensor | None = None
        # optional utils.Counters sink (the engine sets it at install
        # time): uncertified fallbacks land in `sq8_fallback_queries`
        self.counters = None

    # -- persistence ------------------------------------------------------

    @classmethod
    def build_from_reader(cls, reader, fetch: int = DEFAULT_FETCH,
                          chunk: int = 1 << 18,
                          store_mtime: float | None = None) -> "SQ8Index":
        """Quantize the store into staged sidecar files and publish them
        (write + rename — a crashed build never leaves a loadable
        half-sidecar). Direct-to-memmap: peak host RAM is one chunk.

        ``store_mtime`` (the manifest mtime the caller's reader was
        opened under) is stamped into the meta: it pins the sidecar to
        the exact store generation its bounds were derived from, so a
        build that races a re-index reads as "no sidecar" for the new
        store (stale bounds are not upper bounds for the new rows)."""
        root = Path(reader.root)
        tmp_bin = root / (_F_BIN + ".tmp")
        tmp_sc = root / (_F_SCALES + ".tmp")
        tmp_meta = root / (_F_META + ".tmp")
        n, d = reader.count, reader.dim
        e8 = np.memmap(tmp_bin, dtype=np.int8, mode="w+", shape=(n, d))
        scal2 = np.memmap(tmp_sc, dtype=np.float32, mode="w+", shape=(2, n))
        off = 0
        for shard in reader.shard_arrays():
            for s in range(0, shard.shape[0], chunk):
                q8, sc = quantize_rows(as_float32(shard[s : s + chunk]))
                e8[off : off + len(q8)] = q8
                scal2[:, off : off + len(q8)] = sc
                off += len(q8)
        e8.flush()
        scal2.flush()
        meta = {
            "version": _SQ8_VERSION, "count": n, "dim": d,
            "src_dtype": reader.dtype_name,
        }
        if store_mtime is not None:
            meta["store_mtime"] = store_mtime
        tmp_meta.write_text(json.dumps(meta))
        # bins first, meta LAST: the meta rename publishes the sidecar
        tmp_bin.replace(root / _F_BIN)
        tmp_sc.replace(root / _F_SCALES)
        tmp_meta.replace(root / _F_META)
        return cls(
            np.memmap(root / _F_BIN, dtype=np.int8, mode="r", shape=(n, d)),
            np.asarray(
                np.memmap(root / _F_SCALES, dtype=np.float32, mode="r",
                          shape=(2, n))
            ),
            reader, fetch=fetch,
        )

    @classmethod
    def load(cls, reader, fetch: int = DEFAULT_FETCH,
             store_mtime: float | None = None) -> "SQ8Index | None":
        """Open a persisted sidecar; None on any anomaly (missing files,
        count/dim/dtype mismatch, short bins) — the engine then rebuilds.
        Coarse staleness vs the store manifest is the CALLER's check
        (file-mtime rule); pass ``store_mtime`` to additionally require the
        build-time stamp to match the exact store generation (sidecars
        written without a stamp pass — the file-mtime rule covers them)."""
        root = Path(reader.root)
        try:
            meta = json.loads((root / _F_META).read_text())
            if (
                meta.get("version") != _SQ8_VERSION
                or meta.get("count") != reader.count
                or meta.get("dim") != reader.dim
                or meta.get("src_dtype") != reader.dtype_name
            ):
                return None
            if (
                store_mtime is not None
                and "store_mtime" in meta
                and meta["store_mtime"] != store_mtime
            ):
                return None
            n, d = reader.count, reader.dim
            if (root / _F_BIN).stat().st_size != n * d:
                return None
            if (root / _F_SCALES).stat().st_size != 2 * n * 4:
                return None
            e8 = np.memmap(root / _F_BIN, dtype=np.int8, mode="r",
                           shape=(n, d))
            scal2 = np.asarray(
                np.memmap(root / _F_SCALES, dtype=np.float32, mode="r",
                          shape=(2, n))
            )
        except Exception:
            return None
        return cls(e8, scal2, reader, fetch=fetch)

    @staticmethod
    def sidecar_mtime(reader) -> float | None:
        try:
            return (Path(reader.root) / _F_META).stat().st_mtime
        except OSError:
            return None

    def device_bytes(self) -> int:
        return self.n * self.dim + 8 * self.n

    # -- search -----------------------------------------------------------

    def ensure_device(self, device: str | torch.device) -> None:
        """Materialize the int8 matrix + scalars on ``device`` (the caller —
        the engine — reserves the device budget first), copied from the
        mmap in chunks: no whole-sidecar host copy."""
        if self._e8_d is None:
            device = torch.device(device)
            e8 = torch.empty((self.n, self.dim), dtype=torch.int8, device=device)
            for s in range(0, self.n, _UPLOAD_ROWS):
                blk = np.array(self.e8[s : s + _UPLOAD_ROWS])  # writable copy
                e8[s : s + blk.shape[0]] = torch.from_numpy(blk).to(device)
            self._scal2_d = torch.from_numpy(
                np.array(self.scal2, np.float32)  # writable copy
            ).to(device)
            self._e8_d = e8

    def _gather_rows(self, ids: np.ndarray) -> np.ndarray:
        """Widened f32 rows for sorted-unique global ids, straight off
        the mmap shards — the rerank reads ~fetch rows/query, not the
        corpus."""
        out = np.empty((ids.shape[0], self.dim), np.float32)
        off = 0
        for shard in self.reader.shard_arrays():
            hi = off + shard.shape[0]
            m = (ids >= off) & (ids < hi)
            if m.any():
                out[m] = as_float32(shard[ids[m] - off])
            off = hi
        return out

    def _rerank_queries(self, queries: np.ndarray) -> np.ndarray:
        """The query the score contract demands: bf16 stores round it to
        bf16 first (index.search.exact_search_host does the same), so
        certified SQ8 scores are the host scan's score function applied
        to the same operands."""
        if self.reader.dtype_name == "bfloat16":
            return as_float32(bf16_bits(queries))
        return queries

    def search_batch(self, queries: np.ndarray, k: int):
        """(Q, d) queries -> exact (scores (Q, k) f32, ids (Q, k) i64)
        under the global (score desc, index asc) tie contract."""
        from .search import query_row_bucket

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
        if self._e8_d is None:
            raise RuntimeError("SQ8Index.ensure_device(device) must run first")
        tile = self.tile_rows
        grid = -(-self.n // tile)
        c_total = grid * 2 * TREE_CLASSES
        fetch = min(max(self.fetch, k + 32), c_total)
        full_fetch = fetch == c_total
        # the serving path's query-row buckets (extra rows repeat row 0),
        # so the kernel runs at the query counts every other route uses
        pad = query_row_bucket(nq)
        qpad = queries
        if pad > nq:
            qpad = np.concatenate(
                [queries, np.broadcast_to(queries[:1], (pad - nq, queries.shape[1]))]
            )
        fb, fid, cnt_ok, m3max = _sq8_select(
            self._e8_d, self._scal2_d,
            torch.tensor(qpad, device=self._e8_d.device), fetch, tile,
        )
        fb = fb[:nq].cpu().numpy()
        ids = fid[:nq].cpu().numpy()
        cnt_ok = cnt_ok[:nq].cpu().numpy()
        m3max = m3max[:nq].cpu().numpy()
        mf = fb[:, -1]
        # NEG_INF-bound slots (tiny/tail-only classes) carry rows past the
        # corpus: keep them out of the gather and the ranking
        finite = np.isfinite(fb) & (fb > np.float32(NEG_INF) / 2)
        ids = np.where(finite, ids, 0)

        def cert(qi: int, m: float) -> bool:
            return bool(
                m3max[qi] < m
                and (full_fetch or (cnt_ok[qi] and m >= mf[qi]))
            )

        return rerank_and_certify(self, queries, ids, finite, k, cert)
