"""Splits the time of the f32 candidate kernels (B1 and B2 on three TF32
passes, ``ops/csrc/topk_tc.cuh``) between the tensor cores and the split.

    python -m evossearch_tpu_torch.scripts.split_f32_time

Builds two variants of ``topk_tc.cuh`` from a copy of ``ops/csrc`` into
``evossearch_tpu_torch/_build/f32_variants/`` and times each beside the
shipped kernels, B1 over 1,048,576 and B2 over 262,144 seeded unit rows of
d = 512 at Q = 1, 48 and 128 (CUDA-event medians of 20 launches):

  shipped    three passes on the split words
  one_pass   big*big only (the split still made, its small parts unused)
  no_split   three passes on the raw words: the MMAs without the split's
             integer and f32 work

The variants' scores are not the function (no search uses them). For
``no_split`` each line also gives the tensor cores' rate that its time
implies, 3*2*Q*N*d over its ms: a floor under what mma.sync sustains for
TF32 inside this kernel. Prints the card's name and power limit, then one
JSON object per variant. Needs a CUDA device and raises without one.
"""

from __future__ import annotations

import json
import shutil
import subprocess

import torch

from evossearch_tpu_torch.ops import _build, topk
from evossearch_tpu_torch.scripts.bench_candidates import time_ms

N_TREE, N_BLOCK, D = 1 << 20, 1 << 18, 512
QUERIES = (1, 48, 128)
PASSES = """            mma_tf32(acc[1][m][i], as[m], bb0, bb1);
            mma_tf32(acc[2][m][i], ab[m], bs0, bs1);
"""
SPLIT = """  big = x & 0xffffe000u;
  const float rest = __fsub_rn(__uint_as_float(x), __uint_as_float(big));
  small = (__float_as_uint(rest) + 0x1000u) & 0xffffe000u;"""


def variants(source: str) -> dict[str, str]:
    """The header's text per variant; raises if the header no longer holds
    the code a variant edits."""
    if PASSES not in source or SPLIT not in source:
        raise RuntimeError("topk_tc.cuh no longer holds the code the variants edit")
    return {"shipped": source, "one_pass": source.replace(PASSES, ""),
            "no_split": source.replace(SPLIT, "  big = x;\n  small = x;")}


def run(seed: int = 0) -> list[dict]:
    if not torch.cuda.is_available():
        raise RuntimeError("split_f32_time needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(N_TREE, D, generator=gen, device="cuda")
    x /= torch.linalg.norm(x, dim=1, keepdim=True)
    q = torch.randn(max(QUERIES), D, generator=gen, device="cuda")
    q /= torch.linalg.norm(q, dim=1, keepdim=True)
    root = _build.BUILD_DIR / "f32_variants"
    saved = _build.CSRC, _build.BUILD_DIR
    rows = []
    try:
        for name, text in variants((_build.CSRC / "topk_tc.cuh").read_text()).items():
            csrc = root / name / "csrc"
            shutil.rmtree(csrc, ignore_errors=True)
            shutil.copytree(saved[0], csrc)
            (csrc / "topk_tc.cuh").write_text(text)
            _build.CSRC, _build.BUILD_DIR = csrc, csrc.parent / "_build"
            _build._loaded.clear()
            row = {"variant": name, "d": D, "tree_n": N_TREE, "block_n": N_BLOCK}
            for nq in QUERIES:
                tree = time_ms(lambda: topk.tree_candidates(x, q[:nq], 8192))
                block = time_ms(lambda: topk.block_candidates(x[:N_BLOCK], q[:nq], 4))
                row[f"tree_ms_q{nq}"], row[f"block_ms_q{nq}"] = tree, block
                if name == "no_split":
                    row[f"tf32_tflops_q{nq}"] = 6 * nq * N_TREE * D / tree / 1e9
            rows.append(row)
    finally:
        _build.CSRC, _build.BUILD_DIR = saved
        _build._loaded.clear()
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
