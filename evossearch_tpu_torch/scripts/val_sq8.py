"""Validation of the SQ8 certified capacity tier at scale on one CUDA GPU.

    python -m evossearch_tpu_torch.scripts.val_sq8

Counterpart of the JAX package's ``scripts/val_sq8.py``, both phases:

  A (the production path, 1,048,576 and 2,097,152 rows): unit Gaussian
    rows rounded to bf16 are made on the card and copied once to the host
    as a bf16 store holds them (uint16 bits); ``quantize_rows`` on the
    host, an ``SQ8Index`` over a reader of that one host array (as over the
    mmap store), ``ensure_device``, then ``search_batch`` of 48 unit
    queries (p50 of 7, host clock): the bound sweep, the host rerank with
    the store's score contract, the certificates and the host fallback.
    Held against a float64 host oracle over the same bytes (widened rows
    x bf16(q)) by the search routes' rule (``bench.agreement``).
    Certified: the queries that took no fallback (the index's counter);
    matching: the queries equal to the oracle, which must be all.

  B (capacity, 20,971,520 rows): only the int8 corpus and its scalars are
    on the card, quantized there chunk by chunk, and the truth is the
    dequantized corpus (``scale_i * e8_i``, exact in float64 in any
    order): the select at fetch 512, 256 and 128 (CUDA events, median of
    20 launches), the rerank against the dequantized rows and the
    certificates; every certified query must equal the dequantized
    oracle.

Rows are made once and every comparison gathers from that one array:
rows made again in a second program need not be bit-equal to the first.

Prints the card's name and power limit, then one JSON object per
measurement; exits 1 when a check fails. Needs a CUDA device and raises
without one.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from .. import bench
from ..ops import topk

K, Q, FETCH = 48, 48, 512
A_ROWS = (1 << 20, 2 << 20)
B_ROWS = 20 << 20
B_FETCHES = (512, 256, 128)
CHUNK = 1 << 19


class HostReader:
    """One host array of bf16 bits as a store reader (``SQ8Index``'s
    rerank and fallback read rows through ``shard_arrays``)."""

    dtype_name = "bfloat16"

    def __init__(self, bits: np.ndarray):
        self._bits = bits
        self.count, self.dim = bits.shape

    def shard_arrays(self):
        return [self._bits]


def phase_a(device, rows=A_ROWS) -> list[dict]:
    from ..index.sq8 import SQ8Index, quantize_rows
    from ..index.store import as_float32
    from ..utils import Counters

    device = torch.device(device)
    d = bench.DIM
    out = []
    for n in rows:
        gen = torch.Generator(device=device).manual_seed(n)
        emb = bench.unit_rows(n, d, gen, device, dtype=torch.bfloat16)
        bits = emb.view(torch.int16).cpu().numpy().view(np.uint16)  # the one host copy
        del emb
        queries = bench.unit_rows(Q, d, torch.Generator(device=device).manual_seed(n + 1),
                                  device).cpu().numpy()
        e8, scal2 = quantize_rows(as_float32(bits))
        idx = SQ8Index(e8, scal2, HostReader(bits), fetch=FETCH, tile_rows=bench.SQ8_TILE)
        idx.counters = Counters()
        idx.ensure_device(device)
        s, i = idx.search_batch(queries, K)  # also the first calls
        certified = Q - int(idx.counters.snapshot().get("sq8_fallback_queries", 0))
        ms = bench.host_ms(lambda: idx.search_batch(queries, K), 7)
        host = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
        verdict = bench.agreement(s, i, host, bench.bf16_queries(torch.from_numpy(queries)),
                                  bench.err_unit(torch.bfloat16, d))
        out.append({"phase": "A", "rows": n, "search_ms_p50": bench.median(ms), "n": 7,
                    "ms_per_query": bench.median(ms) / Q, "certified": certified,
                    "matching": verdict["matching"], "queries": Q,
                    "score_err_over_bound_max": verdict["score_err_over_bound_max"],
                    "ok": verdict["ok"]})
        del idx, bits, e8, host
    return out


def phase_b(device, n: int = B_ROWS, fetches=B_FETCHES, chunk: int = CHUNK) -> list[dict]:
    from ..index.sq8 import _sq8_select

    device = torch.device(device)
    run = bench.Run(device)
    d = bench.DIM
    e8, scal2 = bench.sq8_corpus(n, chunk, n, device, normalize=True)
    queries = bench.unit_rows(Q, d, torch.Generator(device=device).manual_seed(n + 1), device)
    qb = bench.bf16_queries(queries)
    o_s, o_i = bench.sq8_oracle(e8, scal2, qb, K)  # fetch-free: once for the ladder
    exact = bench.exactly_summable(qb)
    out = []
    for fetch in fetches:
        bench._zero_launches()
        ms = bench.device_ms(run, lambda: _sq8_select(e8, scal2, queries, fetch,
                                                      bench.SQ8_TILE), 20)
        s, i, cert = bench.sq8_certified(e8, scal2, queries, fetch, K)
        verdict = bench.sq8_verdict(s, i, cert, o_s, o_i)
        out.append({"phase": "B", "rows": n, "fetch": fetch,
                    "select_ms_p50": bench.median(ms), "n": len(ms),
                    "GB_per_s": n * (d + 8) / (bench.median(ms) * 1e-3) / 1e9,
                    "certified": verdict["certified"], "matching": verdict["matching"],
                    "queries": Q, "launches": {k: v for k, v in topk.DTYPE_LAUNCHES.items() if v},
                    "ok": verdict["ok"] and exact})
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("val_sq8: no CUDA device; it validates the card's SQ8 tier")
    device = torch.device("cuda", torch.cuda.current_device())
    card = bench.card_info(device)
    print(f"{card['name']}, {card['power_limit']}", flush=True)
    rows = []
    for phase in (phase_a, phase_b):
        for row in phase(device):
            print(json.dumps({**row, "device": card["kind"]}), flush=True)
            rows.append(row)
        torch.cuda.empty_cache()
    return 0 if all(row["ok"] for row in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
