"""Smoke run of evossearch_tpu_torch on one CUDA GPU.

    python3 chip_smoke.py

Builds the top-k kernels from evossearch_tpu_torch/ops/csrc with nvcc
(one nvcc per source, in parallel), holds each against its plain PyTorch
version and a dense oracle (a stable sort written here), times them (and
checks and times the dense path's selection, stable_topk, against that
sort and torch.topk), then drives five paths, each with the launch
counts set to 0 just before it and read just after (and last checks the
block and tree kernels at 67,110,913 rows of d = 128, f32 and bf16, past
the 67,106,816 rows the block kernel's grid once capped it at):

  * the SQ8 time split (``evossearch_tpu_torch.scripts.exp_sq8_perf``):
    B1, B3 and B3's two E1 variants (``sq8_variant``) over 1,048,576 and
    10,485,760 seeded unit rows, and the tier's device half;
  * f32 corpora of 262,144 and 1,048,576 seeded unit rows on the card
    through the search routing (``index.search.best_exact_search_batch``),
    so B2 and B1 run on their f32 paths;

and, at full ViT-B/32 width (random weights, bf16 compute and store):

  * the main path: the HTTP app indexes 64 JPEGs and answers /search and
    /search_by_image, and text searches over two seeded stores of 262,144
    and 1,048,576 rows reach the block and the tree kernel through the
    engine's normal routing;
  * the library entry point ``evossearch_tpu_torch.ops.fused_topk`` (the
    single-query stream kernel) over the 1,048,576-row store, bf16 as the
    engine holds it and an f32 copy;
  * the over-budget folder: a 2,097,152-row store (2 GiB of bf16) under a
    device budget lowered to 1536 MiB through EVOSSEARCH_HBM_BUDGET_MB
    (a store over the card's own 80% budget would need over 64 GB of
    disk), so the engine's routing sends its text and embedding searches
    to the SQ8 tier and the int8 bound-sweep kernel; one search is then
    split into its stages (device half, copy back, row gather, rerank and
    certificate).

Every line on stdout but the last is one result: a JSON object, or the
card's name and power limit as nvidia-smi reports them. In the closing
``kernels`` line, ``sq8_variant`` reports the bf16_struct variant (both
variants have a ``kernel_check`` line), and ``tree_f32``, ``block_f32``
and ``stream_f32`` the kernels' f32 paths. The last line is
{"ok": true, "device": {...}}. Any failed check raises and the script
exits non-zero with no last line. Without a GPU it exits 1 at once.
"""

from __future__ import annotations

import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

D = 512          # ViT-B/32 embedding width
Q = 48           # query batch of the kernel checks (the MAX_RESULTS batch)
QUERY_BUCKETS = (1, 8, 64, 128)  # query rows the serving path pads a batch to
N_BLOCK = 1 << 18   # smallest store the kernels serve: the block kernel at k=48
N_BLOCK_TAIL = 300_007  # a partial last 2048-row tile of the block kernel
# past the 67,106,816 rows (cdiv(n, 2048) * 2 blocks in a grid's y) at which
# the block kernel once failed to launch; the last tile is partial
N_BLOCK_GRID = 67_110_913
D_BLOCK_GRID = 128  # the narrowest width, so both dtypes fit on the card
N_TREE = 1 << 20    # the tree kernel at k=12 and k=48
N_SQ8 = 1 << 21     # the over-budget folder, and the SQ8 kernel checks
N_SQ8_TAIL = 1_000_003  # a partial last SQ8 tile, n % 4 != 0 (radd unaligned)
N_STREAM = 1 << 20  # the stream kernel checks
SQ8_BUDGET_MB = 1536  # corpus 2 GiB over it, sidecar 1.02 GiB within it
SQ8_FETCH = 512       # the tier's default fetch (EVOSSEARCH_SQ8_FETCH)
HBM_BYTES_PER_S = 3.35e12           # H100 SXM HBM3
# dense bf16 tensor cores, f32 FMA on the CUDA cores, TF32 tensor cores
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12, "tf32": 495e12}
TF32_PASSES = 3  # the f32 candidate kernels' products per f32 product
SCORE_ATOL = 1e-5  # dense-oracle score tolerance: summation order only
REPLACES = {
    "block": "evossearch_tpu/ops/topk_pallas.py:279",
    "tree": "evossearch_tpu/ops/topk_pallas.py:579",
    "sq8": "evossearch_tpu/ops/topk_pallas.py:664",
    "stream": "evossearch_tpu/ops/topk_pallas.py:129",
    "sq8_variant": "scripts/exp_sq8_perf.py:87",
}
SOURCES = {name: f"evossearch_tpu_torch/ops/csrc/topk_{name.split('_')[0]}.cu"
           for name in REPLACES}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``reps`` runs, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def exact_inputs(n: int, dtype, gen: torch.Generator):
    """Rows and 128 queries of small integers over 16: every dot is exact
    in float32 in any summation order, and equal scores tie for real."""
    emb = torch.randint(-4, 5, (n, D), generator=gen, device="cuda") / 16.0
    q = torch.randint(-4, 5, (max(QUERY_BUCKETS), D), generator=gen,
                      device="cuda") / 16.0
    return emb.to(dtype).contiguous(), q.float()


def unit_rows(n: int, gen: torch.Generator, device="cuda") -> torch.Tensor:
    x = torch.randn(n, D, generator=gen, device=device)
    return x / torch.linalg.norm(x, dim=1, keepdim=True)


def same_ranking(s, i, s_ref, i_ref) -> bool:
    """Top-k equal to the oracle's: scores within SCORE_ATOL, and the same
    row at every rank whose oracle score is more than SCORE_ATOL from its
    neighbours' (only a near-tie may order by summation noise)."""
    s, i, s_ref, i_ref = (np.asarray(a) for a in (s, i, s_ref, i_ref))
    if s.shape != s_ref.shape or not np.allclose(s, s_ref, rtol=0, atol=SCORE_ATOL):
        return False
    gap = np.full(s_ref.shape, np.inf)
    d = np.abs(np.diff(s_ref, axis=-1))
    gap[..., 1:] = d
    gap[..., :-1] = np.minimum(gap[..., :-1], d)
    clear = gap > SCORE_ATOL
    return bool(np.array_equal(i[clear], i_ref[clear]))


def bound_ms_of(nbytes: int, ops: int, peak) -> tuple[float, str]:
    """Least time for ``nbytes`` moved at the HBM rate against ``ops``
    operations at ``PEAK_FLOPS[peak]``: the larger, and which."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FLOPS[peak] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_ms(n: int, q: int, dtype, out) -> tuple[float, str]:
    """Least time for one candidate pass: each input byte read once and
    each output byte written once at the HBM rate, against the products
    at their peak rate: 2*q*n*d bf16 products for a bf16 corpus, and for
    an f32 one the 3*2*q*n*d TF32 products of its three passes."""
    nbytes = _pass_bytes(n, q, dtype, out)
    if dtype == torch.float32:
        return bound_ms_of(nbytes, TF32_PASSES * 2 * q * n * D, "tf32")
    return bound_ms_of(nbytes, 2 * q * n * D, dtype)


def _pass_bytes(n: int, q: int, dtype, out) -> int:
    itemsize = torch.tensor([], dtype=dtype).element_size()
    return n * D * itemsize + q * D * 4 + sum(t.numel() * t.element_size() for t in out)


def oracle_topk(scores: torch.Tensor, k: int):
    """The dense oracle's selection, written here apart from the code
    under test: a stable descending sort of whole rows, cut to k."""
    vals, pos = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], pos[..., :k]


def oracle_scores(emb: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(Q, N) f32 scores as every exact path defines them: queries rounded
    to bf16 for a bf16 corpus, rows widened exactly, f32 products."""
    if emb.dtype == torch.bfloat16:
        q = q.to(torch.bfloat16).float()
    return q @ emb.float().T


def library_topk(emb: torch.Tensor, q: torch.Tensor, k: int):
    """The yardstick: one cuBLAS product with float32 scores, then
    torch.topk (no tie contract). Timed only; the port never calls it."""
    scores = torch.mm(q.to(emb.dtype), emb.t(), out_dtype=torch.float32) \
        if emb.dtype == torch.bfloat16 else torch.mm(q, emb.t())
    return torch.topk(scores, k, dim=1)


def kernel_checks(topk, search) -> dict:
    """Phase 3: each kernel against its plain version, its final result
    against the dense oracle, its timings and its bound."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {}
    cases = [("block", N_BLOCK, 48), ("tree", N_TREE, 48), ("tree", N_TREE, 12)]
    for dtype in (torch.bfloat16, torch.float32):
        for name, n, k in cases:
            dname = "bf16" if dtype == torch.bfloat16 else "f32"
            if name == "block":
                cand = lambda e, qq: topk.block_candidates(e, qq, topk.default_levels(n))
                plain = lambda e, qq: topk.block_candidates_plain(e, qq, topk.default_levels(n))
                fused = topk.fused_topk_batch
            else:
                tile = topk._tree_tile_rows(dtype)
                cand = lambda e, qq: topk.tree_candidates(e, qq, tile)
                plain = lambda e, qq: topk.tree_candidates_plain(e, qq, tile)
                fused = topk.fused_topk_batch_tree
            check(topk.use_tree_kernel(n, k, dtype) == (name == "tree"),
                  f"routing sends N={n} k={k} {dname} to {name}")
            # (a) exact-dot inputs: bit for bit at Q and at every query
            # bucket of the serving path (the candidates do not depend on
            # k), certified rows and fallback
            emb, q_all = exact_inputs(n, dtype, gen)
            q = q_all[:Q]
            bit_equal_q = (Q,) + (QUERY_BUCKETS if k == 48 else ())
            for nq in bit_equal_q:
                got = cand(emb, q_all[:nq])
                torch.cuda.synchronize()
                want = plain(emb, q_all[:nq])
                check(all(torch.equal(a, b) for a, b in zip(got, want)),
                      f"{name} {dname} candidates at Q={nq} equal the plain "
                      "version bit for bit")
                del got, want
            extra = block_bit_equality(topk, emb, dtype) if name == "block" else {}
            o_s, o_i = oracle_topk(oracle_scores(emb, q), k)
            ok, s, i = fused(emb, q, k)
            okc = ok.cpu()
            check(torch.equal(s[ok], o_s[ok]) and torch.equal(i[ok], o_i[ok]),
                  f"{name} {dname} certified rows equal the oracle (exact dots)")
            fs, fi = search.pallas_search_batch(emb, q, k)
            check(np.array_equal(fs, o_s.cpu().numpy())
                  and np.array_equal(fi, o_i.cpu().numpy()),
                  f"{name} {dname} results with fallback equal the oracle")
            exact_cert = float(okc.float().mean())
            # (b) random unit rows
            emb = unit_rows(n, gen).to(dtype).contiguous()
            q_128 = unit_rows(max(QUERY_BUCKETS), gen)
            q = q_128[:Q]
            ok, s, i = fused(emb, q, k)
            o_s, o_i = oracle_topk(oracle_scores(emb, q), k)
            okn = ok.cpu().numpy()
            check(same_ranking(s.cpu().numpy()[okn], i.cpu().numpy()[okn],
                               o_s.cpu().numpy()[okn], o_i.cpu().numpy()[okn]),
                  f"{name} {dname} k={k} certified rows equal the oracle (unit rows)")
            # the kernel's candidate scores against the plain version's on
            # unit rows: equal up to float32 summation order
            out = cand(emb, q)
            ref = plain(emb, q)
            err = max(float((a - b).abs().max()) for a, b in zip(out, ref)
                      if a.dtype == torch.float32)
            check(err <= SCORE_ATOL, f"{name} {dname} candidate scores within "
                  f"{SCORE_ATOL} of the plain version on unit rows ({err})")
            del ref
            # (c) timings, (d) bound; for f32 also the bound of the earlier
            # CUDA-core design (2*q*n*d f32 FMAs at 67 TFLOP/s)
            b_ms, b_by = bound_ms(n, Q, dtype, out)
            if dtype == torch.float32:
                extra["bound_ms_cuda_core"] = bound_ms_of(
                    _pass_bytes(n, Q, dtype, out), 2 * Q * n * D, torch.float32)[0]
                if name == "tree" and k == 48:
                    extra.update(f32_accumulation_check(topk))
            row = {
                "phase": "kernel_check", "kernel": name, "dtype": dname,
                "n": n, "d": D, "q": Q, "k": k,
                "bit_equal_plain_at_q": list(bit_equal_q), **extra, "max_abs_err": err,
                "cert_rate_exact_inputs": exact_cert,
                "cert_rate_unit_rows": float(okn.mean()),
                "ms": time_ms(lambda: cand(emb, q)),
                "ms_q1": time_ms(lambda: cand(emb, q[:1])),
                "ms_q128": time_ms(lambda: cand(emb, q_128)),
                "plain_ms": time_ms(lambda: plain(emb, q)),
                "merge_ms": time_ms(lambda: fused(emb, q, k)),
                "library_ms": time_ms(lambda: library_topk(emb, q, k)),
                "bound_ms": b_ms, "bound_by": b_by,
            }
            emit(row)
            rows[(name, dname, k)] = row
            del emb, q, q_128, q_all, out
            torch.cuda.empty_cache()
    return rows


def block_bit_equality(topk, emb: torch.Tensor, dtype) -> dict:
    """The block kernel at the depth the N_BLOCK case does not take
    (levels 3) on its exact-dot rows, and at N_BLOCK_TAIL rows (a partial
    last tile), each bit for bit at Q and every query bucket. Its own
    generator leaves kernel_checks' inputs as they were without it."""
    bit_equal_q = (Q,) + QUERY_BUCKETS
    gen = torch.Generator(device="cuda").manual_seed(9)
    tail, q_all = exact_inputs(N_BLOCK_TAIL, dtype, gen)
    for rows, levels in ((emb, 3), (tail, topk.default_levels(N_BLOCK_TAIL))):
        for nq in bit_equal_q:
            got = topk.block_candidates(rows, q_all[:nq], levels)
            torch.cuda.synchronize()
            want = topk.block_candidates_plain(rows, q_all[:nq], levels)
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"block candidates at N={rows.shape[0]} levels={levels} Q={nq} "
                  "equal the plain version bit for bit")
    del tail, got, want
    return {"bit_equal_plain_at_levels": [topk.default_levels(N_BLOCK), 3],
            "bit_equal_plain_at_n": [N_BLOCK, N_BLOCK_TAIL]}


def block_grid_check(topk) -> list[dict]:
    """The block kernel past its old grid cap, and the tree kernel at the
    same size: N_BLOCK_GRID exact-dot rows of width D_BLOCK_GRID, f32 (34
    GB) and then bf16, 8 queries, each kernel bit for bit against its plain
    version; each corpus is filled in chunks (one integer draw over the
    whole shape would need 68 GB of int64) and freed before the next."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    n, d, chunk = N_BLOCK_GRID, D_BLOCK_GRID, 1 << 20
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        emb = torch.empty((n, d), dtype=dtype, device="cuda")
        for s in range(0, n, chunk):
            m = min(chunk, n - s)
            emb[s : s + m] = torch.randint(-4, 5, (m, d), generator=gen, device="cuda",
                                           dtype=torch.int8).to(dtype) / 16
        q = torch.randint(-4, 5, (8, d), generator=gen, device="cuda").float() / 16
        got = topk.block_candidates(emb, q, 4)
        torch.cuda.synchronize()
        want = topk.block_candidates_plain(emb, q, 4)
        dname = "bf16" if dtype == torch.bfloat16 else "f32"
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"block {dname} candidates at N={n} d={d} equal the plain version bit for bit")
        del got, want
        row = {"phase": "block_past_old_grid_cap", "dtype": dname, "n": n, "d": d,
               "q": 8, "levels": 4, "blocks": -(-n // topk.TILE_ROWS) * 8,
               "bit_equal_plain": True,
               "ms": time_ms(lambda: topk.block_candidates(emb, q, 4), reps=5)}
        emit(row)
        rows.append(row)
        tile = topk._tree_tile_rows(dtype)
        got = topk.tree_candidates(emb, q, tile)
        torch.cuda.synchronize()
        want = topk.tree_candidates_plain(emb, q, tile)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"tree {dname} candidates at N={n} d={d} equal the plain version bit for bit")
        del got, want
        row = {"phase": "tree_largest_corpus", "dtype": dname, "n": n, "d": d, "q": 8,
               "tile_rows": tile, "bit_equal_plain": True,
               "ms": time_ms(lambda: topk.tree_candidates(emb, q, tile), reps=5)}
        emit(row)
        rows.append(row)
        del emb
        torch.cuda.empty_cache()
    return rows


def exact_sq8_inputs(n: int, gen: torch.Generator):
    """int8 rows, power-of-two scales, queries of small integers over 16:
    every bound's dot is exact in float32, and equal bounds tie for real."""
    e8 = torch.randint(-127, 128, (n, D), generator=gen, device="cuda",
                       dtype=torch.int8)
    scale = 2.0 ** -torch.randint(5, 10, (n,), generator=gen, device="cuda").float()
    radd = torch.rand(n, generator=gen, device="cuda") * 1e-2
    q = torch.randint(-4, 5, (max(QUERY_BUCKETS), D), generator=gen,
                      device="cuda") / 16.0
    return e8, torch.stack([scale, radd]).contiguous(), q.float()


def sq8_checks(topk) -> dict:
    """The SQ8 bound sweep against its plain version (bit for bit on
    exact-dot inputs at Q and every query bucket, at N_SQ8 rows and at
    N_SQ8_TAIL rows; within SCORE_ATOL on unit rows quantized on the card),
    the rigor of every emitted bound, the certification rate beside the
    plain version's, timings and bound."""
    from evossearch_tpu_torch.index import sq8 as sq8_mod
    from evossearch_tpu_torch.index.sq8 import _sq8_select, quantize_rows_device

    gen = torch.Generator(device="cuda").manual_seed(4)
    n, tile = N_SQ8, topk.SQ8_TILE_ROWS
    bit_equal_q = (Q,) + QUERY_BUCKETS
    for rows_n in (n, N_SQ8_TAIL):
        e8, scal2, q_all = exact_sq8_inputs(rows_n, gen)
        qn_all = torch.linalg.norm(q_all, dim=1)
        for nq in bit_equal_q:
            got = topk.sq8_candidates(e8, scal2, q_all[:nq], qn_all[:nq], tile)
            torch.cuda.synchronize()
            want = topk.sq8_candidates_plain(e8, scal2, q_all[:nq], qn_all[:nq], tile)
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"sq8 candidates at N={rows_n} Q={nq} equal the plain version bit for bit")
            del got, want
        del e8, scal2, q_all
    # unit rows of a bf16 store, quantized on the card
    rows = unit_rows(n, gen).to(torch.bfloat16).float()
    e8, scal2 = quantize_rows_device(rows)
    q = unit_rows(Q, gen)
    qn = torch.linalg.norm(q, dim=1)
    out = topk.sq8_candidates(e8, scal2, q, qn, tile)
    ref = topk.sq8_candidates_plain(e8, scal2, q, qn, tile)
    err = max(float((a - b).abs().max()) for a, b in zip(out, ref)
              if a.dtype == torch.float32)
    check(err <= SCORE_ATOL, f"sq8 candidate bounds within {SCORE_ATOL} of the "
          f"plain version on unit rows ({err})")
    del ref
    # rigor: every emitted bound dominates its row's exact f32 score,
    # against the f32 query and the bf16-rounded one
    cand_s, cand_i = out[0], out[1].long()
    worst = -math.inf
    for qq in (q, q.bfloat16().float()):
        exact = (qq @ rows.T).gather(1, cand_i)
        worst = max(worst, float((exact - cand_s).max()))
    check(worst <= 0, f"every sq8 candidate bound >= its row's exact score ({worst})")
    # certification rate of the tier at k = 48: the device half, then the
    # rerank's certificate computed here on the card; beside it the same
    # with the plain version's candidates, which the kernel may trail by at
    # most one query
    k = 48
    qb = q.bfloat16().float()

    def certified():
        fb, fid, cnt_ok, m3max = _sq8_select(e8, scal2, q, SQ8_FETCH, tile)
        exact = (rows[fid] * qb[:, None, :]).sum(-1)
        m = torch.topk(exact, k, dim=1).values[:, -1]
        return (m3max < m) & cnt_ok & (m >= fb[:, -1])

    cert = certified()
    sq8_mod.sq8_candidates = topk.sq8_candidates_plain
    try:
        cert_plain = certified()
    finally:
        sq8_mod.sq8_candidates = topk.sq8_candidates
    check(int(cert.sum()) >= int(cert_plain.sum()) - 1,
          f"sq8 certifies {int(cert.sum())} of {Q} queries at k = {k}, at most one "
          f"fewer than with the plain version's candidates ({int(cert_plain.sum())})")
    b_ms, b_by = bound_ms_of(
        n * D + 8 * n + Q * D * 4 + Q * 4 + sum(t.numel() * 4 for t in out),
        2 * Q * n * D, torch.bfloat16)
    e_bf = e8.to(torch.bfloat16)  # the library yardstick's widened corpus
    q_128 = unit_rows(max(QUERY_BUCKETS), gen)
    qn_128 = torch.linalg.norm(q_128, dim=1)
    row = {
        "phase": "kernel_check", "kernel": "sq8", "dtype": "int8", "n": n,
        "d": D, "q": Q, "k": k, "tile_rows": tile,
        "bit_equal_plain_at_q": list(bit_equal_q),
        "bit_equal_plain_at_n": [n, N_SQ8_TAIL], "max_abs_err": err,
        "bound_minus_exact_max": worst,
        "cert_rate_unit_rows": float(cert.float().mean()),
        "cert_rate_unit_rows_plain": float(cert_plain.float().mean()),
        "ms": time_ms(lambda: topk.sq8_candidates(e8, scal2, q, qn, tile)),
        "ms_q1": time_ms(lambda: topk.sq8_candidates(e8, scal2, q[:1], qn[:1], tile)),
        "ms_q128": time_ms(lambda: topk.sq8_candidates(e8, scal2, q_128, qn_128, tile)),
        "plain_ms": time_ms(lambda: topk.sq8_candidates_plain(e8, scal2, q, qn, tile)),
        "merge_ms": time_ms(lambda: _sq8_select(e8, scal2, q, SQ8_FETCH, tile)),
        "library_ms": time_ms(lambda: library_topk(e_bf, q, k)),
        "bound_ms": b_ms, "bound_by": b_by,
    }
    emit(row)
    del rows, e8, scal2, e_bf, out, exact
    torch.cuda.empty_cache()
    return row


def sq8_variant_checks(topk) -> dict:
    """E1's two variants against their plain versions: bit for bit on
    exact-dot inputs (int8 values, also as bf16, where they are exact) at Q
    and every query bucket, at N_SQ8 and N_SQ8_TAIL rows; within
    SCORE_ATOL on unit rows quantized on the card; the tensor cores'
    accumulation (``accumulation_check``); timings and bound. library_ms is
    B3's yardstick: cuBLAS on the corpus as bf16, plus torch.topk."""
    from evossearch_tpu_torch.index.sq8 import quantize_rows_device

    gen = torch.Generator(device="cuda").manual_seed(7)
    n, tile = N_SQ8, topk.SQ8_TILE_ROWS
    bit_equal_q = (Q,) + QUERY_BUCKETS
    for rows_n in (n, N_SQ8_TAIL):
        e8, scal2, q_all = exact_sq8_inputs(rows_n, gen)
        qn_all = torch.linalg.norm(q_all, dim=1)
        for variant, exact in (("bf16_struct", e8.to(torch.bfloat16)),
                               ("int8_noscale", e8)):
            for nq in bit_equal_q:
                got = topk.sq8_variant_candidates(exact, scal2, q_all[:nq], qn_all[:nq],
                                                  variant, tile)
                torch.cuda.synchronize()
                want = topk.sq8_variant_candidates_plain(exact, scal2, q_all[:nq],
                                                         qn_all[:nq], variant, tile)
                check(all(torch.equal(a, b) for a, b in zip(got, want)),
                      f"sq8_variant {variant} at N={rows_n} Q={nq} equals the plain "
                      "version bit for bit")
                del got, want
            del exact
        del e8, scal2, q_all
    accumulation = accumulation_check(topk, gen)
    rows16 = unit_rows(n, gen).to(torch.bfloat16)
    u8, uscal2 = quantize_rows_device(rows16)
    q = unit_rows(Q, gen)
    qn = torch.linalg.norm(q, dim=1)
    q_128 = unit_rows(max(QUERY_BUCKETS), gen)
    qn_128 = torch.linalg.norm(q_128, dim=1)
    out_rows = {}
    for variant, unit in (("bf16_struct", rows16), ("int8_noscale", u8)):
        cand = lambda: topk.sq8_variant_candidates(unit, uscal2, q, qn, variant, tile)
        out = cand()
        ref = topk.sq8_variant_candidates_plain(unit, uscal2, q, qn, variant, tile)
        # int8_noscale's figures are raw dots in int8 units (up to ~300
        # here): SCORE_ATOL holds relative to the largest figure
        err = max(float((a - b).abs().max()) for a, b in zip(out, ref)
                  if a.dtype == torch.float32)
        top = max(1.0, float(ref[0].abs().max()))
        check(err <= SCORE_ATOL * top, f"sq8_variant {variant} figures within "
              f"{SCORE_ATOL} x {top} of the plain version on unit rows ({err})")
        del ref
        nbytes = n * D * unit.element_size() + Q * D * 4
        nbytes += (8 * n + Q * 4) if variant == "bf16_struct" else 0
        b_ms, b_by = bound_ms_of(nbytes + sum(t.numel() * 4 for t in out),
                                 2 * Q * n * D, torch.bfloat16)
        e_bf = unit.to(torch.bfloat16)
        row = {
            "phase": "kernel_check", "kernel": "sq8_variant", "variant": variant,
            "dtype": str(unit.dtype).replace("torch.", ""), "n": n, "d": D, "q": Q,
            "k": 48, "tile_rows": tile, "bit_equal_plain_at_q": list(bit_equal_q),
            "bit_equal_plain_at_n": [n, N_SQ8_TAIL], "max_abs_err": err,
            **(accumulation if variant == "int8_noscale" else {}),
            "ms": time_ms(cand),
            "ms_q1": time_ms(lambda: topk.sq8_variant_candidates(
                unit, uscal2, q[:1], qn[:1], variant, tile)),
            "ms_q128": time_ms(lambda: topk.sq8_variant_candidates(
                unit, uscal2, q_128, qn_128, variant, tile)),
            "plain_ms": time_ms(lambda: topk.sq8_variant_candidates_plain(
                unit, uscal2, q, qn, variant, tile)),
            "library_ms": time_ms(lambda: library_topk(e_bf, q, 48)),
            "bound_ms": b_ms, "bound_by": b_by,
        }
        emit(row)
        out_rows[variant] = row
        del out, e_bf
    del rows16, u8, uscal2
    torch.cuda.empty_cache()
    return out_rows


def accumulation_check(topk, gen: torch.Generator) -> dict:
    """The tensor cores' accumulation against the model the SQ8 certificate
    relies on (ops/csrc/topk_tc.cuh): int8_noscale's emitted raw dots
    (cand_s at cand_i) over cancellation-heavy rows (int8 values of
    alternating sign by column, a one-signed bf16 query whose values span
    2^14, so partial sums need more than 24 bits) against float64 dots of
    the same rows. The worst error, in units of d*2^-24*sum|e8*q~|, must be
    at most 2 (a truncating accumulation's bound)."""
    n, tile = N_SQ8_TAIL, topk.SQ8_TILE_ROWS
    sign = (1 - 2 * (torch.arange(D, device="cuda") % 2)).to(torch.int16)
    e8 = (torch.randint(64, 128, (n, D), generator=gen, device="cuda",
                        dtype=torch.int16) * sign).to(torch.int8)
    mag = torch.rand(Q, D, generator=gen, device="cuda") + 0.5
    q = mag * 2.0 ** -torch.randint(0, 14, (Q, D), generator=gen, device="cuda").float()
    q = (q / torch.linalg.norm(q, dim=1, keepdim=True)).bfloat16().float()
    cand_s, cand_i, _ = topk.sq8_variant_candidates(e8, None, q, None, "int8_noscale", tile)
    worst = 0.0
    qd = q.double()
    for j in range(Q):
        live = cand_i[j] < n  # the partial last tile's padding rows
        rows = e8[cand_i[j][live].long()].double()
        p = rows * qd[j]
        err = (cand_s[j][live].double() - p.sum(1)).abs()
        worst = max(worst, float((err / (D * 2.0 ** -24 * p.abs().sum(1))).max()))
    check(worst <= 2, f"tensor-core accumulation error within 2*d*2^-24*sum|p| ({worst})")
    del e8, cand_s, cand_i
    return {"accumulation_err_ratio_max": worst, "accumulation_rows": n}


def f32_accumulation_check(topk) -> dict:
    """accumulation_check's f32 case: B1's f32 path (three TF32 passes,
    ops/csrc/topk_tc.cuh) emits cand_s at cand_i over cancellation-heavy
    f32 rows (full mantissas, alternating sign by column, magnitudes
    spanning 2^14) against a one-signed f32 query spanning 2^14, held
    against float64 dots of the same rows. The worst error, in units of
    the split's error model (2^-19 + 2*d*2^-24)*sum|x*q|, must be at most
    1. Its own generator leaves kernel_checks' inputs as they were."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    n, tile = N_SQ8_TAIL, topk._tree_tile_rows(torch.float32)
    sign = 1 - 2 * (torch.arange(D, device="cuda") % 2)
    mag = torch.rand(n, D, generator=gen, device="cuda") + 0.5
    x = mag * 2.0 ** -torch.randint(0, 14, (n, D), generator=gen, device="cuda").float() * sign
    del mag
    q = torch.rand(Q, D, generator=gen, device="cuda") + 0.5
    q = q * 2.0 ** -torch.randint(0, 14, (Q, D), generator=gen, device="cuda").float()
    q = q / torch.linalg.norm(q, dim=1, keepdim=True)
    cand_s, cand_i, _ = topk.tree_candidates(x, q, tile)
    unit = 2.0 ** -19 + 2 * D * 2.0 ** -24
    worst = 0.0
    qd = q.double()
    for j in range(Q):
        live = cand_i[j] < n  # the partial last tile's padding rows
        p = x[cand_i[j][live].long()].double() * qd[j]
        err = (cand_s[j][live].double() - p.sum(1)).abs()
        worst = max(worst, float((err / (unit * p.abs().sum(1))).max()))
    check(worst <= 1, f"f32 tensor-core scores within (2^-19 + 2*d*2^-24)*sum|x*q| ({worst})")
    del x, cand_s, cand_i
    torch.cuda.empty_cache()
    return {"f32_err_ratio_max": worst, "f32_err_rows": n}


def sq8_split_path(topk) -> int:
    """The SQ8 time split (scripts/exp_sq8_perf.run) with the launch counts
    set to 0 just before and read just after; returns the E1 variants'
    launches on this path."""
    from evossearch_tpu_torch.scripts import exp_sq8_perf

    for name in topk.LAUNCHES:
        topk.LAUNCHES[name] = 0
    rows = exp_sq8_perf.run()
    launches = dict(topk.LAUNCHES)
    check(launches["sq8_variant"] > 0, "the sq8_variant kernel ran on the sq8_split path")
    for row in rows:
        check(all(math.isfinite(v) and v > 0 for k, v in row.items()
                  if k.endswith("_ms") and k != "merge_ms"),
              f"sq8_split times at N={row['n']} are finite")
        emit(dict(row, launches=launches))
    torch.cuda.empty_cache()
    return launches["sq8_variant"]


def f32_search_path(topk, search) -> dict:
    """The f32 paths of B2 and B1: f32 corpora of N_BLOCK and N_TREE
    seeded unit rows on the card (a STORE_DTYPE=float32 folder as the
    engine holds it), searched at k = 48 through the routing the engine
    calls (``best_exact_search_batch``), with the launch counts set to 0
    just before and read just after; each result is then held against the
    dense oracle."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    corpora = {n: unit_rows(n, gen) for n in (N_BLOCK, N_TREE)}
    queries = unit_rows(Q, gen).cpu().numpy()
    k = 48
    for name in topk.LAUNCHES:
        topk.LAUNCHES[name] = 0
    out = {n: search.best_exact_search_batch(emb, queries, k) for n, emb in corpora.items()}
    torch.cuda.synchronize()
    launches = dict(topk.LAUNCHES)
    check(launches["block"] > 0 and launches["tree"] > 0,
          f"the block and tree kernels ran on their f32 path ({launches})")
    for n, emb in corpora.items():
        s, i = out[n]
        o_s, o_i = search.exact_search_batch(emb, torch.from_numpy(queries), k)
        check(np.all(np.isfinite(s)) and s.shape == (Q, k)
              and same_ranking(s, i, o_s, o_i),
              f"f32 search over {n} rows equals the dense oracle")
    emit({"phase": "f32_search_path", "n": list(corpora), "k": k, "q": Q,
          "kernel": {n: "tree" if topk.use_tree_kernel(n, k, torch.float32) else "block"
                     for n in corpora},
          "launches": launches, "equals_dense_oracle": True})
    del corpora
    torch.cuda.empty_cache()
    return launches


def dense_topk_times(topk) -> dict:
    """Fault C2, the dense exact path's selection: ``stable_topk`` against
    the smoke's stable sort, values and positions, on random and on
    tie-heavy scores (rounded to 1/8) at Q = 1, 48 and 128; its time
    against one ``torch.topk`` (no tie contract, the yardstick) and the
    full stable sort it replaced, on (Q, 2^18 - 1) f32 scores (the widest
    a folder on the dense path has), k = 48; at Q = 1-16 the sort and the
    fetch path apart, where the crossover lies; and both on the short rows
    of the plain candidate versions (48 queries: 1024 blocks of 256 at
    k = 4, block; 64 tiles x 128 classes of 128 groups at k = 3, tree)."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    row = {"phase": "dense_topk_c2", "n": N_BLOCK - 1, "k": 48}
    crossover = topk._SORT_MAX_SCORES, topk._FETCH_MIN_RATIO

    def fetch_ms(x, k):
        topk._SORT_MAX_SCORES, topk._FETCH_MIN_RATIO = 0, 1
        try:
            return time_ms(lambda: topk.stable_topk(x, k))
        finally:
            topk._SORT_MAX_SCORES, topk._FETCH_MIN_RATIO = crossover

    for nq in (1, 2, 4, 8, 16, 48, 128):
        s = torch.randn(nq, N_BLOCK - 1, generator=gen, device="cuda")
        ties = torch.round(s * 8) / 8
        if nq in (1, 48, 128):
            for name, x in (("random", s), ("tie-heavy", ties)):
                got, want = topk.stable_topk(x, 48), oracle_topk(x, 48)
                check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                      f"stable_topk equals a stable sort on {name} scores at Q={nq}")
            row[f"stable_topk_ms_q{nq}"] = time_ms(lambda: topk.stable_topk(s, 48))
            row[f"stable_topk_ties_ms_q{nq}"] = time_ms(lambda: topk.stable_topk(ties, 48))
            row[f"torch_topk_ms_q{nq}"] = time_ms(lambda: torch.topk(s, 48, dim=1))
        row[f"full_sort_ms_q{nq}"] = time_ms(lambda: oracle_topk(s, 48))
        row[f"fetch_ms_q{nq}"] = fetch_ms(s, 48)
    for name, shape, k in (("n256_k4", (Q, 1024, 256), 4), ("n128_k3", (Q, 64, 128, 128), 3)):
        s = torch.randn(shape, generator=gen, device="cuda")
        row[f"short_rows_sort_ms_{name}"] = time_ms(lambda: oracle_topk(s, k))
        row[f"short_rows_fetch_ms_{name}"] = fetch_ms(s, k)
    emit(row)
    return row


def stream_equal(topk, emb: torch.Tensor, q: torch.Tensor, k: int, what: str) -> None:
    """The stream kernel bit-equal to its plain version and to the dense
    oracle; ``q`` has norm exactly 1, so the kernel's normalization keeps
    it, and every score is exact."""
    s, i = topk.fused_topk(emb, q, k)
    ps, pi = topk.fused_topk_plain(emb, q, k)
    check(torch.equal(s, ps) and torch.equal(i, pi),
          f"stream {what} k={k} equals the plain version bit for bit")
    os_, oi = oracle_topk(emb.float() @ q, k)
    m = os_.numel()
    check(torch.equal(s[:m], os_) and torch.equal(i[:m], oi)
          and bool((s[m:] == topk.NEG_INF).all()) and bool((i[m:] == -1).all()),
          f"stream {what} k={k} equals the dense oracle (exact dots)")


def stream_checks(topk) -> dict:
    """The single-query stream kernel against its plain version and the
    dense oracle, bit for bit on exact-dot inputs (rows of integers over
    16, a query of 256 entries +-1/16 of norm exactly 1) at k = 1, 48 and
    128: over 1,048,576 rows; with a plateau of rows tied at the best
    score on both sides of every block boundary of the persistent grid;
    on 32,000 strictly ascending scores (every row enters); at n = 1, 40,
    70,001 and one row past blocks x tile rows. Then on unit rows: within
    SCORE_ATOL of the plain version with the same ranking, timings and
    bound at k = 12, 48 and 128. bf16 and f32."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = {}
    n = N_STREAM
    for dtype in (torch.bfloat16, torch.float32):
        dname = "bf16" if dtype == torch.bfloat16 else "f32"
        emb, _ = exact_inputs(n, dtype, gen)
        q = torch.zeros(D, device="cuda")
        pick = torch.randperm(D, generator=gen, device="cuda")[:256]
        q[pick] = (torch.randint(0, 2, (256,), generator=gen, device="cuda") * 2 - 1) / 16.0
        tile, blocks = topk._stream_layout(n, D, emb.element_size(), sms)
        tiles = -(-n // tile)
        edges = [b * tiles // blocks * tile for b in range(1, blocks)]
        band = torch.tensor([e + j for e in edges for j in (-2, -1, 0, 1)], device="cuda")
        plateau = emb.clone()
        plateau[band] = (torch.sign(q) / 4).to(dtype)  # score 4, above every other row
        bits = torch.arange(0x80, 0x80 + 32_000, dtype=torch.int32, device="cuda")
        ascending = torch.zeros(32_000, D, dtype=torch.bfloat16, device="cuda")
        ascending[:, 0] = bits.to(torch.int16).view(torch.bfloat16)  # ascending, exact
        e0 = torch.zeros(D, device="cuda")
        e0[0] = 1.0
        past = blocks * tile + 1  # one tile more than blocks: one block takes two
        cases = [(emb, q, f"{dname} n={n}"), (plateau, q, f"{dname} tie plateau"),
                 (ascending.to(dtype), e0, f"{dname} ascending")]
        cases += [(emb[:m], q, f"{dname} n={m}") for m in (1, 40, 70_001, past)]
        for e, qq, what in cases:
            for k in (1, 48, 128):
                stream_equal(topk, e, qq, k, what)
        del plateau, cases
        emb = unit_rows(n, gen).to(dtype).contiguous()
        q = torch.randn(D, generator=gen, device="cuda")
        for k in (12, 48, 128):
            s, i = topk.fused_topk(emb, q, k)
            ps, pi = topk.fused_topk_plain(emb, q, k)
            err = float((s - ps).abs().max())
            check(err <= SCORE_ATOL and same_ranking(
                s.cpu()[None], i.cpu()[None], ps.cpu()[None], pi.cpu()[None]),
                f"stream {dname} k={k} on unit rows equals the plain version ({err})")
            itemsize = emb.element_size()
            b_ms, b_by = bound_ms_of(n * D * itemsize + D * 4 + k * 8,
                                     2 * n * D, torch.float32)
            qn = q / torch.linalg.norm(q)
            row = {
                "phase": "kernel_check", "kernel": "stream", "dtype": dname,
                "n": n, "d": D, "q": 1, "k": k, "tile_rows": tile, "blocks": blocks,
                "bit_equal_plain_k": [1, 48, 128],
                "bit_equal_n": [n, 1, 40, 70_001, past, 32_000], "max_abs_err": err,
                "ms": time_ms(lambda: topk.fused_topk(emb, q, k)),
                "plain_ms": time_ms(lambda: topk.fused_topk_plain(emb, q, k)),
                "library_ms": time_ms(lambda: library_topk(emb, qn[None], k)),
                "bound_ms": b_ms, "bound_by": b_by,
            }
            emit(row)
            rows[(dname, k)] = row
        del emb
        torch.cuda.empty_cache()
    return rows


def write_jpegs(folder: Path, count: int) -> list[Path]:
    """Seeded JPEGs of mixed sizes, one of them a panorama."""
    from PIL import Image

    rng = np.random.default_rng(0)
    sizes = [(480, 640), (640, 480), (224, 224), (300, 500), (768, 1024),
             (1080, 1920), (375, 500), (512, 512)]
    paths = []
    for i in range(count):
        h, w = (400, 4000) if i == count - 1 else sizes[i % len(sizes)]
        base = rng.integers(0, 256, (h // 16 + 1, w // 16 + 1, 3), dtype=np.uint8)
        img = Image.fromarray(base).resize((w, h), Image.Resampling.BILINEAR)
        p = folder / f"img_{i:03d}.jpg"
        img.save(p, quality=90)
        paths.append(p)
    return paths


def write_store(folder: Path, n: int, gen: torch.Generator) -> None:
    """A bf16 ViT-B/32 store of ``n`` seeded unit rows."""
    from evossearch_tpu_torch.index import IndexWriter

    folder.mkdir(parents=True, exist_ok=True)
    w = IndexWriter.create(folder, model="ViT-B/32", dim=D, dtype_name="bfloat16")
    chunk = 1 << 18
    for start in range(0, n, chunk):
        m = min(chunk, n - start)
        emb = unit_rows(m, gen).cpu().numpy()
        paths = [str(folder / f"row_{start + j}.jpg") for j in range(m)]
        meta = [{"path": p, "mtime": 0.0, "size": 0} for p in paths]
        w.append(emb, paths, meta)
    w.finalize()


def tower_times(engine) -> dict:
    """Device time of the image tower on one indexing batch of 224 px
    inputs and of the text tower on one query, CUDA events."""
    from evossearch_tpu_torch.models import encode_image, encode_text

    spec, dtype = engine.spec, engine._compute_dtype
    gen = torch.Generator(device="cuda").manual_seed(3)
    batch = engine._index_batch
    images = torch.randn(batch, spec.image_size, spec.image_size, 3,
                         generator=gen, device="cuda").to(dtype)
    tokens = torch.randint(0, spec.vocab_size, (1, spec.context_length),
                           generator=gen, device="cuda")
    image_ms = time_ms(lambda: encode_image(engine.params, images, dtype), reps=10)
    text_ms = time_ms(lambda: encode_text(engine.params, tokens, dtype), reps=10)
    return {"phase": "towers", "image_batch": batch, "image_tower_ms": image_ms,
            "image_tower_images_per_s": batch / image_ms * 1e3,
            "text_tower_ms_batch1": text_ms}


def library_path(topk, engine, folder: Path) -> dict:
    """The stream kernel's path: the public entry point
    ``evossearch_tpu_torch.ops.fused_topk`` on the 1,048,576-row store as
    the engine holds it on the card (bf16), then on an f32 copy of it, for
    one text query's embedding, with the launch counts set to 0 just
    before each and read just after. Returns the launches of each:
    ``stream`` (bf16) and ``stream_f32``."""
    from evossearch_tpu_torch.ops import fused_topk

    entry, reader = engine._cached_index(str(folder))
    emb_d = engine._entry_emb(entry, reader)
    q = torch.as_tensor(engine.encode_text("a photo of a horse"), device="cuda")
    counted = {}
    for key, emb in (("stream", emb_d), ("stream_f32", emb_d.float())):
        for name in topk.LAUNCHES:
            topk.LAUNCHES[name] = 0
        out = {k: fused_topk(emb, q, k) for k in (12, 48)}
        torch.cuda.synchronize()
        launches = dict(topk.LAUNCHES)
        check(launches["stream"] > 0, f"the stream kernel ran on its path ({key})")
        counted[key] = launches["stream"]
        for k, (s, i) in out.items():
            os_, oi = oracle_topk((emb.float() @ (q / torch.linalg.norm(q)))[None], k)
            check(same_ranking(s.cpu()[None], i.cpu()[None], os_.cpu(), oi.cpu()),
                  f"ops.fused_topk ({key}) k={k} over {reader.count} rows equals the "
                  "dense oracle")
        emit({"phase": "library_path", "store": folder.name, "n": reader.count,
              "dtype": str(emb.dtype).removeprefix("torch."), "launches": launches,
              "equals_dense_oracle": True})
        del emb, out
    return counted


def sq8_stage_split(topk, idx, query: np.ndarray, k: int, reps: int = 10) -> dict:
    """One embedding search of the SQ8 tier split into its stages, timed
    around the tier's own calls in SQ8Index.search_batch's order (median
    host-clock ms over ``reps``): the device half (``_sq8_select``, then a
    synchronize; also its CUDA-event time), the copy of its four outputs to
    the host, the row gather off the mmap store (``_gather_rows``), and the
    host rerank plus certificate (``rerank_and_certify`` handed the rows
    just gathered); beside them, the whole ``search_batch``."""
    from evossearch_tpu_torch.index.sq8 import _sq8_select, rerank_and_certify

    q = np.asarray(query, np.float32)[None]
    tile = idx.tile_rows
    c_total = -(-idx.n // tile) * 2 * topk.TREE_CLASSES
    fetch = min(max(idx.fetch, k + 32), c_total)
    qd = torch.tensor(q, device=idx._e8_d.device)
    laps = {name: [] for name in ("device", "copy", "gather", "rerank_cert", "search")}
    for _ in range(reps):
        t0 = time.perf_counter()
        out = _sq8_select(idx._e8_d, idx._scal2_d, qd, fetch, tile)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fb, ids, cnt_ok, m3max = (t.cpu().numpy() for t in out)
        t2 = time.perf_counter()
        finite = np.isfinite(fb) & (fb > np.float32(topk.NEG_INF) / 2)
        ids = np.where(finite, ids, 0)
        rows = idx._gather_rows(np.unique(ids))
        t3 = time.perf_counter()
        mf = fb[:, -1]

        def cert(qi, m):
            return bool(m3max[qi] < m
                        and (fetch == c_total or (cnt_ok[qi] and m >= mf[qi])))

        idx._gather_rows = lambda _ids: rows  # measurement only: no second gather
        try:
            rerank_and_certify(idx, q, ids, finite, k, cert)
        finally:
            del idx._gather_rows
        t4 = time.perf_counter()
        idx.search_batch(q, k)
        t5 = time.perf_counter()
        for name, lap in zip(laps, (t1 - t0, t2 - t1, t3 - t2, t4 - t3, t5 - t4)):
            laps[name].append(lap * 1e3)
    split = {f"stage_{name}_ms": statistics.median(v) for name, v in laps.items()}
    split["stage_device_event_ms"] = time_ms(
        lambda: _sq8_select(idx._e8_d, idx._scal2_d, qd, fetch, tile))
    return split


def over_budget_path(topk, engine, work: Path, gen: torch.Generator) -> dict:
    """The SQ8 tier's path: a 2,097,152-row bf16 store over a device budget
    lowered to SQ8_BUDGET_MB, searched through the engine's normal
    routing (text at k = 12 and 48, then 8 concurrent embedding searches,
    which the host batcher sends as one batch), with the launch counts set
    to 0 just before and read just after. The first search builds the
    sidecar inline; a second engine then loads it without rebuilding."""
    from evossearch_tpu_torch.core import Config
    from evossearch_tpu_torch.engine import SearchEngine, _canon
    from evossearch_tpu_torch.index.search import exact_search_host_reader_batch
    from evossearch_tpu_torch.index.store import IndexReader

    folder = work / f"store_{N_SQ8}"
    t0 = time.perf_counter()
    write_store(folder, N_SQ8, gen)
    store_s = time.perf_counter() - t0
    os.environ["EVOSSEARCH_HBM_BUDGET_MB"] = str(SQ8_BUDGET_MB)
    os.environ["EVOSSEARCH_SQ8_SYNC_ROWS"] = str(2 * N_SQ8)
    try:
        cfg = Config(env_path=work / "missing.env")
    finally:
        del os.environ["EVOSSEARCH_HBM_BUDGET_MB"], os.environ["EVOSSEARCH_SQ8_SYNC_ROWS"]
    emit({"phase": "over_budget_setup", "n": N_SQ8, "store_dtype": "bfloat16",
          "store_written_s": store_s, "corpus_bytes": N_SQ8 * D * 2,
          "sidecar_bytes": N_SQ8 * (D + 8), "budget_mb": cfg.HBM_BUDGET_MB,
          "reduction": "device budget lowered from 80% of the card to "
                       f"{SQ8_BUDGET_MB} MiB through EVOSSEARCH_HBM_BUDGET_MB, "
                       "so a 2 GiB store is over it: a store over the card's "
                       "own budget would need over 64 GB of disk",
          "sq8": cfg.SQ8, "sq8_sync_rows": cfg.SQ8_SYNC_ROWS})
    eng = SearchEngine(cfg=cfg, params=engine.params, device="cuda")
    text = "a photo of a bird"
    rng = np.random.default_rng(6)
    embs = rng.standard_normal((8, D)).astype(np.float32)
    embs /= np.linalg.norm(embs, axis=1, keepdims=True)
    sidecar = folder / ".clip_index" / "sq8.json"

    for name in topk.LAUNCHES:
        topk.LAUNCHES[name] = 0
    t_wall = time.time()
    t0 = time.perf_counter()
    first = eng.search_text(str(folder), text, 12)
    first_s = time.perf_counter() - t0
    build_s = sidecar.stat().st_mtime - t_wall
    results = {("text", 12): first}
    t0 = time.perf_counter()
    results[("text", 48)] = eng.search_text(str(folder), text, 48)
    text48_ms = (time.perf_counter() - t0) * 1e3
    seq_ms = []
    for j in range(4):
        t0 = time.perf_counter()
        results[("emb", j)] = eng.search_embedding(str(folder), embs[j], 48)
        seq_ms.append((time.perf_counter() - t0) * 1e3)
    out = [None] * len(embs)

    def run(j):
        out[j] = eng.search_embedding(str(folder), embs[j], 48)

    threads = [threading.Thread(target=run, args=(j,)) for j in range(len(embs))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    concurrent_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    launches = dict(topk.LAUNCHES)
    snap = eng.counters.snapshot()
    check(launches["sq8"] > 0, "the sq8 kernel ran on the over-budget path")
    check(snap.get("sq8_queries", 0) > 0, "the SQ8 tier served the over-budget folder")

    entry = eng._index_cache[_canon(str(folder))]
    check("emb" not in entry and entry.get("sq8") is not None,
          "the folder's corpus stayed off the card and the sidecar is installed")
    check(entry["device_bytes"] == entry["sq8"].device_bytes() == N_SQ8 * (D + 8),
          "the folder holds N*(d+8) device bytes")
    # correctness against the exact host scan
    reader = IndexReader.open(folder)
    q_text = eng.encode_text(text)
    queries = np.concatenate([q_text[None], embs])
    t0 = time.perf_counter()
    o_s, o_i = exact_search_host_reader_batch(reader, queries, 48)
    oracle_s = time.perf_counter() - t0
    for (kind, key), (scores, idx, _) in list(results.items()) + [
            (("emb", j), r) for j, r in enumerate(out)]:
        row = 0 if kind == "text" else 1 + key
        kk = len(idx)
        check(same_ranking(scores[None], idx[None], o_s[row:row + 1, :kk], o_i[row:row + 1, :kk]),
              f"over-budget {kind} {key} equals the exact host scan")
    # a second engine loads the persisted sidecar without rebuilding
    mtime = sidecar.stat().st_mtime
    eng2 = SearchEngine(cfg=cfg, params=engine.params, device="cuda")
    t0 = time.perf_counter()
    again = eng2.search_embedding(str(folder), embs[0], 48)
    reload_s = time.perf_counter() - t0
    check(sidecar.stat().st_mtime == mtime, "the second engine did not rebuild the sidecar")
    check(eng2.counters.snapshot().get("sq8_queries", 0) == 1
          and np.array_equal(again[1], results[("emb", 0)][1]),
          "the second engine served the folder from the persisted sidecar")
    stages = sq8_stage_split(topk, entry["sq8"], embs[0], 48)
    row = {"phase": "over_budget_path", "n": N_SQ8, "launches": launches,
           "first_search_s": first_s, "sidecar_build_s": build_s,
           "text_k48_ms": text48_ms, "search_ms_sequential_k48": seq_ms,
           "concurrent_8_ms": concurrent_ms, "reload_first_search_s": reload_s,
           "sq8_queries": snap.get("sq8_queries", 0),
           "sq8_fallback_queries": snap.get("sq8_fallback_queries", 0),
           "host_routed_queries": snap.get("host_routed_queries", 0),
           "host_oracle_s": oracle_s, "equals_host_scan": True, **stages}
    emit(row)
    eng2.close()
    eng.close()
    return launches


def main_path(topk, search) -> dict:
    """The three paths in a temporary directory that is removed after."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        return run_main_path(topk, search, Path(tmp))


def run_main_path(topk, search, work: Path) -> dict:
    """Phases 4 and 5, one run of the main path with the launch counts
    set to 0 just before and read just after; then the stream kernel's
    and the SQ8 tier's paths, each counted the same way. Returns each
    kernel's launches on its own path."""
    from evossearch_tpu_torch.core import Config
    from evossearch_tpu_torch.engine import SearchEngine
    from evossearch_tpu_torch.index.store import IndexReader, as_float32
    from evossearch_tpu_torch.server import TestClient, create_app

    for key in list(os.environ):
        if key.startswith("EVOSSEARCH_"):
            del os.environ[key]
    cfg = Config(env_path=work / "missing.env")
    imgs = work / "photos"
    imgs.mkdir()
    jpegs = write_jpegs(imgs, 64)
    gen = torch.Generator(device="cuda").manual_seed(2)
    small, large = work / "store_262144", work / "store_1048576"
    t0 = time.perf_counter()
    write_store(small, N_BLOCK, gen)
    write_store(large, N_TREE, gen)
    emit({"phase": "setup", "stores_written_s": time.perf_counter() - t0})

    app = create_app(cfg=cfg, device="cuda")
    engine = app.engine
    check(engine.device.type == "cuda", "the app's engine runs on the GPU")
    t0 = time.perf_counter()
    _ = engine.params
    engine.warmup()
    torch.cuda.synchronize()
    emit({"phase": "model_init", "spec": engine.spec.name,
          "compute_dtype": cfg.COMPUTE_DTYPE, "store_dtype": cfg.STORE_DTYPE,
          "seconds": time.perf_counter() - t0})
    emit(tower_times(engine))
    client = TestClient(app)

    for k in topk.LAUNCHES:
        topk.LAUNCHES[k] = 0
    # -- phase 4: the HTTP routes --
    t0 = time.perf_counter()
    r = client.post("/index", json_body={"folder": str(imgs)})
    index_s = time.perf_counter() - t0
    check(r.status_code == 200 and r.json == {"success": True, "count": 64},
          f"/index indexed 64 images ({r.status_code} {r.json})")
    search_ms = []
    for text in ("a photo of a dog", "a red car", "mountains at sunset",
                 "a photo of a dog"):
        t0 = time.perf_counter()
        r = client.post("/search", json_body={
            "folder": str(imgs), "query": text, "limit": 12})
        search_ms.append((time.perf_counter() - t0) * 1e3)
        res = r.json["results"]
        sims = [x["similarity"] for x in res]
        check(r.status_code == 200 and len(res) == 12
              and all(math.isfinite(v) for v in sims)
              and sims == sorted(sims, reverse=True),
              f"/search answered 12 ranked results ({r.status_code})")
    image_ms = []
    for p in jpegs[:3]:
        t0 = time.perf_counter()
        r = client.post(
            "/search_by_image", data={"folder": str(imgs), "limit": "6"},
            files={"image": ("query.jpg", p.read_bytes())},
        )
        image_ms.append((time.perf_counter() - t0) * 1e3)
        res = r.json["results"]
        check(r.status_code == 200 and len(res) == 6
              and res[0]["filename"] == p.name and res[0]["similarity"] > 0.99,
              f"/search_by_image finds the uploaded {p.name} first")
    emit({"phase": "http_main_path", "images": 64,
          "index_s": index_s, "index_images_per_s": 64 / index_s,
          "search_ms": search_ms, "search_by_image_ms": image_ms})

    # -- phase 5: the kernels through the engine's normal routing --
    results = {}
    for folder, text, k in ((small, "a photo of a dog", 48),
                            (large, "a photo of a cat", 12),
                            (large, "a photo of a cat", 48)):
        t0 = time.perf_counter()
        out = engine.search_text(str(folder), text, k)
        ms = (time.perf_counter() - t0) * 1e3
        check(out is not None, f"{folder.name} is indexed")
        results[(folder.name, k)] = (out, text, ms)
    launches = dict(topk.LAUNCHES)
    emit({"phase": "main_path_launches", "launches": launches})
    check(launches["block"] > 0, "the block kernel ran on the main path")
    check(launches["tree"] > 0, "the tree kernel ran on the main path")
    launches.update(library_path(topk, engine, large))
    launches.update(sq8=over_budget_path(topk, engine, work, gen)["sq8"])

    # -- correctness of what came out (after the counted run) --
    for (name, k), ((scores, idx, reader), text, ms) in results.items():
        entry, _ = engine._cached_index(str(work / name))
        emb_d = engine._entry_emb(entry, reader)
        q = torch.as_tensor(engine.encode_text(text), device="cuda")
        o_s, o_i = search.exact_search_batch(emb_d, q, k)
        check(same_ranking(scores[None], idx[None], o_s, o_i),
              f"{name} k={k} equals the dense oracle on the card")
        emit({"phase": "engine_search", "store": name, "k": k,
              "kernel": "tree" if topk.use_tree_kernel(reader.count, k, emb_d.dtype) else "block",
              "first_call_ms": ms, "equals_dense_oracle": True})
    # the GPU's bf16 embeddings against the same weights in float32 on CPU
    cpu_cfg = Config(env_path=work / "missing.env")
    cpu_cfg.COMPUTE_DTYPE = "float32"
    ref = SearchEngine(cfg=cpu_cfg, device="cpu")
    reader = IndexReader.open(imgs)
    rows = {p: r for r, p in enumerate(reader.paths)}
    stored = as_float32(reader.embeddings())
    picks = [jpegs[0], jpegs[-1]]  # a photo and the panorama
    from evossearch_tpu_torch.preprocess.io import load_image_rgb

    want = ref.encode_images([load_image_rgb(p) for p in picks])
    got = stored[[rows[str(p)] for p in picks]]
    cos_img = (want * got).sum(axis=1) / np.linalg.norm(got, axis=1)
    cos_txt = float(ref.encode_text("a red car") @ engine.encode_text("a red car"))
    emit({"phase": "reference_check", "image_cosine_bf16_gpu_vs_f32_cpu": cos_img.tolist(),
          "text_cosine_bf16_gpu_vs_f32_cpu": cos_txt})
    check(all(np.isfinite(stored).ravel()) and stored.shape == (64, D),
          "stored embeddings are finite (64, 512)")
    check(bool((cos_img > 0.99).all()) and cos_txt > 0.99,
          "GPU bf16 embeddings agree with the float32 CPU encode")
    ref.close()
    engine.close()
    return launches


ROW_TYPES = {"a": "int8", "t": "bf16", "f": "f32"}  # mangled Row -> dtype


def tc_instantiations(build_log: dict) -> dict:
    """Registers and spill-store bytes of every instantiation of the
    tensor-core kernels on ops/csrc/topk_tc.cuh's phases, from ptxas's
    report: "<library>:<row>,<figure>,C<classes>,Q<query cap>" for the
    residue-class kernel, "<library>:<row>,C<rows per rank>,levels<LEV>,
    Q<query cap>" for B2's -> [regs, spill]."""
    out = {}
    for name, log in build_log.items():
        for chunk in log["log"].split("Compiling entry function")[1:]:
            m = re.search(r"tc_kernelI([atf])NS0_\d+([A-Za-z]+)ELi(\d+)ELi(\d+)E", chunk)
            b = re.search(r"block_tc_kernelI([tf])Li(\d+)ELi(\d+)ELi(\d+)E", chunk)
            regs = re.search(r"Used (\d+) registers", chunk)
            spill = re.search(r"(\d+) bytes spill stores", chunk)
            if not (regs and spill):
                continue
            if b:
                key = (f"{name}:{ROW_TYPES[b.group(1)]},C{b.group(2)},levels{b.group(3)},"
                       f"Q{b.group(4)}")
            elif m:
                key = (f"{name}:{ROW_TYPES[m.group(1)]},{m.group(2)},C{m.group(3)},"
                       f"Q{m.group(4)}")
            else:
                continue
            out[key] = [int(regs.group(1)), int(spill.group(1))]
    return out


def stream_instantiations(build_log: dict) -> dict:
    """Registers and spill-store bytes of the stream library's kernels,
    from ptxas's report: "stream_kernel:<row>,QF<query floats a lane
    holds>" and "final_kernel" -> [regs, spill]."""
    out = {}
    log = build_log.get("topk_stream", {}).get("log", "")
    for chunk in log.split("Compiling entry function")[1:]:
        m = re.search(r"stream_kernelI([tf])Li(\d+)E", chunk)
        regs = re.search(r"Used (\d+) registers", chunk)
        spill = re.search(r"(\d+) bytes spill stores", chunk)
        if not (regs and spill):
            continue
        if m:
            key = f"stream_kernel:{ROW_TYPES[m.group(1)]},QF{m.group(2)}"
        elif "final_kernel" in chunk.splitlines()[0]:
            key = "final_kernel"
        else:
            continue
        out[key] = [int(regs.group(1)), int(spill.group(1))]
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from evossearch_tpu_torch.index import search
    from evossearch_tpu_torch.ops import _build, topk

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({"phase": "device", "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "device": torch.cuda.get_device_name(0)})

    t0 = time.perf_counter()
    libs = _build.build()
    build_s = time.perf_counter() - t0
    regs = {
        name: sorted({int(x) for x in re.findall(r"Used (\d+) registers", log["log"])})
        for name, log in _build.BUILD_LOG.items()
    }
    spills = {name: max((int(x) for x in re.findall(r"(\d+) bytes spill stores", log["log"])),
                        default=0)
              for name, log in _build.BUILD_LOG.items()}
    tc_regs = tc_instantiations(_build.BUILD_LOG)
    stream_regs = stream_instantiations(_build.BUILD_LOG)
    emit({"phase": "build", "seconds": build_s, "arch": "sm_90a",
          "libraries": {k: str(v.relative_to(Path.cwd())) if v.is_relative_to(Path.cwd())
                        else str(v) for k, v in libs.items()},
          "registers_per_thread": regs, "max_spill_store_bytes": spills,
          "tc_kernel_registers_spill_bytes": tc_regs,
          "stream_kernel_registers_spill_bytes": stream_regs})
    for lib in ("topk_tree", "topk_block"):
        check(lib not in _build.BUILD_LOG or any(key.startswith(f"{lib}:f32") for key in tc_regs),
              f"the build reports {lib}'s f32 tensor-core instantiations")
    check(all(spill == 0 for _, spill in tc_regs.values()),
          "no tensor-core instantiation spills registers")
    check("topk_stream" not in _build.BUILD_LOG or len(stream_regs) == 7,
          "the build reports the stream kernel's six instantiations and its final merge")
    check(all(spill == 0 for _, spill in stream_regs.values()),
          "no kernel of the stream library spills registers")

    rows = kernel_checks(topk, search)
    rows[("sq8", "int8", 48)] = sq8_checks(topk)
    rows[("sq8_variant", "bf16", 48)] = sq8_variant_checks(topk)["bf16_struct"]
    for (dname, k), row in stream_checks(topk).items():
        rows[("stream", dname, k)] = row
    dense_topk_times(topk)
    variant_launches = sq8_split_path(topk)
    launches = main_path(topk, search)
    launches["sq8_variant"] = variant_launches
    f32_launches = f32_search_path(topk, search)
    launches["tree_f32"], launches["block_f32"] = f32_launches["tree"], f32_launches["block"]
    # last, so the 51 GB it allocates and frees precede no timing
    block_grid_check(topk)

    kernels = []
    for name, dname in (("tree", "bf16"), ("tree", "f32"), ("block", "bf16"),
                        ("block", "f32"), ("sq8", "int8"), ("stream", "bf16"),
                        ("stream", "f32"), ("sq8_variant", "bf16")):
        row = rows[(name, dname, 48)]
        key = f"{name}_f32" if dname == "f32" else name
        kernels.append({
            "name": key, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[key],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
        })
    emit({"kernels": kernels})
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
