"""The control of a cell's check: the reference put in the program's place
and computed in float8 (e4m3, per-tensor scales, float32 accumulation),
the step below the configurations' bfloat16. It has to come out as not
correct under the cell's limits.

    python -m portbench.control --workload <cell> --seeds 11,12,13

The control reads the same inputs a run of the cell compares, made from
the seed: for a search cell the sampled requests' texts of the run's
schedule over the whole library, for an index cell ``sample_per_pass``
images for each of ``--passes`` passes. It depends on no output of the
program, so it needs no window. Prints one JSON line per seed: each
number, its limit, and whether the control fails the check. Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from portbench import data, harness
from portbench.run import judge, load_cell, traffic_kind


def search_readings(run: harness.Run, precision: str) -> dict:
    """rank_gap and score_gap of the reference at ``precision`` against the
    float32 reference, on the requests a run with this seed samples."""
    from portbench.reference import topk
    kind = traffic_kind(run.traffic)

    params, rows, dim = run.traffic, run.traffic["rows"], run.model["embed_dim"]
    reqs = kind.schedule(params, run.seed, run.seconds)
    picked = kind.sample(reqs, params["sample"], run.seed)
    texts = [reqs[i][1] for i in picked]
    limits = np.array([min(reqs[i][2], rows) for i in picked])
    q = kind.reference_queries(run, texts, "fp32")
    qc = kind.reference_queries(run, texts, precision)
    lib = data.library_rows(rows, dim, run.seed, run.device)
    kmax = int(limits.max())
    best, _ = topk.topk(lib, q, kmax)
    cs, ci = topk.topk(lib, qc, kmax)
    rank_gap = score_gap = 0.0
    for r, k in enumerate(limits):
        ref = topk.scores(lib, q[r], ci[r, :k])
        rank_gap = max(rank_gap, float(np.max(best[r, :k] - ref)))
        score_gap = max(score_gap, float(np.max(np.abs(cs[r, :k] - ref))))
    return {"rank_gap": rank_gap, "score_gap": score_gap}


def index_readings(run: harness.Run, precision: str, passes: int) -> dict:
    """cos_gap and cos_gap_median of the reference at ``precision`` against
    the float32 reference, on the images a run with ``passes`` passes
    samples."""
    kind = traffic_kind(run.traffic)

    params = run.traffic
    picks = sorted({i for pick in kind.sampled(run, passes, list(range(params["photos"])))
                    for i in pick})
    all_paths, _ = data.write_photos(run.tmp / "photos", params["photos"], run.seed,
                                     params["photo"], params["writers"], run.device, picks)
    paths = [all_paths[i] for i in picks]
    ref = kind.reference_embeddings(run, paths, "fp32")
    low = kind.reference_embeddings(run, paths, precision)
    gaps = kind.cosine_gaps(low, ref)
    return {"cos_gap": float(gaps.max()), "cos_gap_median": float(np.median(gaps))}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=30.0, help="the runs' window")
    ap.add_argument("--passes", type=int, default=4, help="index passes a run makes")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("portbench.control needs a CUDA device", file=sys.stderr)
        return 2
    workload, config, traffic = load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        tmp = Path(tempfile.mkdtemp(prefix="portbench_control_"))
        t = time.monotonic()
        try:
            run = harness.Run(workload=workload, config=config, traffic=traffic, seed=seed,
                              seconds=args.seconds, trace=False, device="cuda:0", tmp=tmp,
                              started=t)
            if traffic["kind"] == "search_open_loop":
                got = search_readings(run, "fp8")
            else:
                got = index_readings(run, "fp8", args.passes)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        ok, shown = judge(got, workload["limits"], [])
        print(json.dumps({"workload": args.workload, "seed": seed, "precision": "fp8",
                          "correct": ok, "compared": shown,
                          "seconds": time.monotonic() - t,
                          "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
