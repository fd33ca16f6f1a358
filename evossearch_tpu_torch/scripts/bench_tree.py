"""Times the tree candidate kernel (B1) over a bf16 corpus at the query
counts a caller gives it: Q = 1 (a single text search), 48 and 128.

    python -m evossearch_tpu_torch.scripts.bench_tree

It imports ``evossearch_tpu_torch`` by absolute name, so run as a file with
``PYTHONPATH`` set to another checkout's root it times that checkout's
kernel: two trees compare in one call as
``PYTHONPATH=<root> python <this file>`` for each root in turn. The corpus
is 1,048,576 seeded unit rows of d = 512 made on the card, at the bf16
tile (16384 rows); times are CUDA-event medians of 20 launches. Prints the
card's name and power limit, then one JSON object. Needs a CUDA device and
raises without one.
"""

from __future__ import annotations

import json
import statistics
import subprocess

import torch

from evossearch_tpu_torch.ops import topk

N, D = 1 << 20, 512
QUERIES = (1, 48, 128)


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


def run(seed: int = 0) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("bench_tree needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(N, D, generator=gen, device="cuda")
    emb = (x / torch.linalg.norm(x, dim=1, keepdim=True)).bfloat16()
    del x
    q = torch.randn(max(QUERIES), D, generator=gen, device="cuda")
    q /= torch.linalg.norm(q, dim=1, keepdim=True)
    tile = 16384
    return {"kernel": "tree", "dtype": "bf16", "n": N, "d": D, "tile_rows": tile,
            **{f"ms_q{nq}": time_ms(lambda: topk.tree_candidates(emb, q[:nq], tile))
               for nq in QUERIES}}


def main() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(json.dumps(run()), flush=True)


if __name__ == "__main__":
    main()
