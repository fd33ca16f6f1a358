"""Where the SQ8 sweep's time goes on the card: B3 beside its two E1
variants, the tree kernel, and the tier's whole device half.

    python -m evossearch_tpu_torch.scripts.exp_sq8_perf

Counterpart of the JAX package's ``scripts/exp_sq8_perf.py`` (its
:121-197). At N = 1,048,576 and 10,485,760 seeded unit rows of d = 512
(made on the card, stored as bf16, quantized with the tier's own
``quantize_rows_device``) and Q = 48 unit queries, it times with CUDA
events (median of ``reps`` launches, the card's own clock):

  tree          B1 over the bf16 rows, at the SQ8 tile (reference point)
  sq8           B3 over the int8 sidecar: int8 rows, scale stream, bound
  bf16_struct   B3's bound over the bf16 rows: no int8 widening
  int8_noscale  the int8 rows ranked by their raw dot: no scale stream,
                no bound
  select_e2e    the tier's device half (``_sq8_select``, fetch 512): B3,
                the exact top-512 fetch and the counting certificate
  merge         select_e2e - sq8

All five at the SQ8 tile (32768 rows), so every kernel emits the same
candidate layout. Each line of output is one JSON object; ``run()`` returns
them. Needs a CUDA device and raises without one.
"""

from __future__ import annotations

import json
import statistics
import subprocess

import torch

from ..index.sq8 import _sq8_select, quantize_rows_device
from ..ops import topk

D, Q = 512, 48
SIZES = (1 << 20, 10 << 20)
FETCH = 512
_CHUNK = 1 << 19  # rows made and quantized at a time


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
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


def make_corpus(n: int, gen: torch.Generator):
    """``n`` unit rows on the card: (bf16 rows, int8 rows, (2, n) scal2),
    the int8 sidecar quantized from the bf16 rows as the tier does."""
    emb16 = torch.empty((n, D), dtype=torch.bfloat16, device="cuda")
    e8 = torch.empty((n, D), dtype=torch.int8, device="cuda")
    scal2 = torch.empty((2, n), dtype=torch.float32, device="cuda")
    for s in range(0, n, _CHUNK):
        m = min(_CHUNK, n - s)
        x = torch.randn(m, D, generator=gen, device="cuda")
        emb16[s : s + m] = (x / torch.linalg.norm(x, dim=1, keepdim=True)).bfloat16()
        e8[s : s + m], scal2[:, s : s + m] = quantize_rows_device(emb16[s : s + m])
    return emb16, e8, scal2


def run(sizes=SIZES, seed: int = 0, reps: int = 10) -> list[dict]:
    """One row of times (ms) per corpus size."""
    if not torch.cuda.is_available():
        raise RuntimeError("exp_sq8_perf needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(Q, D, generator=gen, device="cuda")
    q /= torch.linalg.norm(q, dim=1, keepdim=True)
    qn = torch.linalg.norm(q, dim=1)
    tile = topk.SQ8_TILE_ROWS
    rows = []
    for n in sizes:
        emb16, e8, scal2 = make_corpus(n, gen)
        calls = {
            "tree": lambda: topk.tree_candidates(emb16, q, tile),
            "sq8": lambda: topk.sq8_candidates(e8, scal2, q, qn, tile),
            "bf16_struct": lambda: topk.sq8_variant_candidates(
                emb16, scal2, q, qn, "bf16_struct", tile),
            "int8_noscale": lambda: topk.sq8_variant_candidates(
                e8, None, q, None, "int8_noscale", tile),
            "select_e2e": lambda: _sq8_select(e8, scal2, q, FETCH, tile),
        }
        ms = {name: time_ms(fn, reps) for name, fn in calls.items()}
        ms["merge"] = ms["select_e2e"] - ms["sq8"]
        rows.append({"phase": "sq8_split", "n": n, "d": D, "q": Q,
                     "tile_rows": tile, "fetch": FETCH,
                     **{f"{name}_ms": t for name, t in ms.items()}})
        del emb16, e8, scal2
        torch.cuda.empty_cache()
    return rows


def main() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    for row in run():
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
