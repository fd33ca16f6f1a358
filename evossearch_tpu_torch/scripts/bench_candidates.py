"""Times the candidate kernels at the query counts a caller gives them:
Q = 1 (a single search), 48, 64 and 128; and the single-query stream
kernel at k = 12, 48 and 128.

    python -m evossearch_tpu_torch.scripts.bench_candidates

  tree          B1 over 1,048,576 bf16 rows at the bf16 tile (16384 rows),
                and over the same rows as f32 at the f32 tile (8192 rows)
  block         B2 over 262,144 bf16 rows at levels 4 and over 4,194,304
                at levels 3 (``default_levels`` of each size), and over
                262,144 of them as f32 at levels 4
  sq8           B3 over 2,097,152 int8 rows at the SQ8 tile (32768 rows)
  bf16_struct   E1: B3's bound over the same rows as bf16
  int8_noscale  E1: the int8 rows ranked by their raw dot
  stream        B4 (``ops.fused_topk``) over the tree's 1,048,576 rows, bf16
                and f32, one query; also each of its kernels' mean device
                time over 10 calls at k = 48 and 128 (``torch.profiler``)

Rows are seeded unit rows of d = 512 made on the card; the int8 rows and
their scalars are quantized from the bf16 rows with the tier's own
``quantize_rows_device`` (``exp_sq8_perf.make_corpus``). Times are
CUDA-event medians of 20 launches. It imports ``evossearch_tpu_torch`` by
absolute name and only names that every checkout since the tensor-core B1
has, so run as a file with ``PYTHONPATH`` set to another checkout's root
it times that checkout's kernels: two trees compare in one call as
``PYTHONPATH=<root> python <this file>`` for each root in turn. Prints the
card's name and power limit, then one JSON object per kernel and size.
Needs a CUDA device and raises without one.
"""

from __future__ import annotations

import json
import statistics
import subprocess

import torch

from evossearch_tpu_torch.ops import topk
from evossearch_tpu_torch.scripts.exp_sq8_perf import make_corpus

N_TREE, N_SQ8, D = 1 << 20, 1 << 21, 512
N_BLOCK = (1 << 18, 1 << 22)
QUERIES = (1, 48, 64, 128)
STREAM_K = (12, 48, 128)


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


def unit_bf16(n: int, gen: torch.Generator, chunk: int = 1 << 20) -> torch.Tensor:
    """``n`` seeded unit rows as bf16 on the card, made in chunks."""
    out = torch.empty((n, D), dtype=torch.bfloat16, device="cuda")
    for s in range(0, n, chunk):
        x = torch.randn(min(chunk, n - s), D, generator=gen, device="cuda")
        out[s : s + x.shape[0]] = (x / torch.linalg.norm(x, dim=1, keepdim=True)).bfloat16()
    return out


def run(seed: int = 0) -> list[dict]:
    """One row of times (ms) per kernel and size."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench_candidates needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(max(QUERIES), D, generator=gen, device="cuda")
    q /= torch.linalg.norm(q, dim=1, keepdim=True)
    qn = torch.linalg.norm(q, dim=1)
    emb16, e8, scal2 = make_corpus(N_SQ8, gen)
    rows16 = unit_bf16(max(N_BLOCK), gen)
    rows32 = rows16[:N_TREE].float()
    tile = topk.SQ8_TILE_ROWS
    calls = [
        ({"kernel": "tree", "dtype": "bf16", "n": N_TREE, "tile_rows": 16384},
         lambda nq: topk.tree_candidates(emb16[:N_TREE], q[:nq], 16384)),
        ({"kernel": "tree", "dtype": "f32", "n": N_TREE, "tile_rows": 8192},
         lambda nq: topk.tree_candidates(rows32, q[:nq], 8192)),
        ({"kernel": "block", "dtype": "f32", "n": N_BLOCK[0], "levels": 4},
         lambda nq: topk.block_candidates(rows32[:N_BLOCK[0]], q[:nq], 4)),
        *(({"kernel": "block", "dtype": "bf16", "n": n,
            "levels": topk.default_levels(n)},
           lambda nq, n=n: topk.block_candidates(rows16[:n], q[:nq],
                                                 topk.default_levels(n)))
          for n in N_BLOCK),
        ({"kernel": "sq8", "dtype": "int8", "n": N_SQ8, "tile_rows": tile},
         lambda nq: topk.sq8_candidates(e8, scal2, q[:nq], qn[:nq], tile)),
        ({"kernel": "bf16_struct", "dtype": "bf16", "n": N_SQ8, "tile_rows": tile},
         lambda nq: topk.sq8_variant_candidates(
             emb16, scal2, q[:nq], qn[:nq], "bf16_struct", tile)),
        ({"kernel": "int8_noscale", "dtype": "int8", "n": N_SQ8, "tile_rows": tile},
         lambda nq: topk.sq8_variant_candidates(
             e8, None, q[:nq], None, "int8_noscale", tile)),
    ]
    rows = [{**head, "d": D, **{f"ms_q{nq}": time_ms(lambda: fn(nq)) for nq in QUERIES}}
            for head, fn in calls]
    for dtype, emb in (("bf16", rows16[:N_TREE]), ("f32", rows32)):
        rows.append({"kernel": "stream", "dtype": dtype, "n": N_TREE, "d": D, **{
            f"ms_k{k}": time_ms(lambda: topk.fused_topk(emb, q[0], k)) for k in STREAM_K},
            **{f"kernel_us_k{k}": kernel_us(lambda: topk.fused_topk(emb, q[0], k))
               for k in STREAM_K[1:]}})
    return rows


def kernel_us(fn, calls: int = 10) -> dict:
    """Mean device time (us) of each CUDA kernel ``fn`` launches, by the
    kernel's name, over ``calls`` calls under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {ev.key.replace("(anonymous namespace)::", "").split("(")[0][-48:]:
            ev.device_time * ev.count / calls
            for ev in prof.key_averages() if ev.device_time > 0}


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
