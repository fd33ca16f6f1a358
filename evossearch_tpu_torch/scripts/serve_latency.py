"""The engine's single-query serving latency on one CUDA GPU.

    python -m evossearch_tpu_torch.scripts.serve_latency

Counterpart of the JAX package's ``scripts/serve_latency.py``. Over a
1,000,000-row f32 store of seeded unit rows written through the real
store, it times the whole ``search_text`` (tokenize, text tower, batched
search, the copy of the results to the host) with a text-cache miss on
every call and with a hit, and ``search_embedding`` of stored rows: the
median of 21 calls each, host clock (every call returns its results on
the host). Each result must hold k = 48 rows, and a stored row searched
by its own embedding must come back first. Prints the card's name and
power limit, then one JSON object per measurement (with the kernel
launches by kernel and corpus dtype of its calls); exits 1 when a check
fails. Needs a CUDA device and raises without one.
"""

from __future__ import annotations

import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from .. import bench
from ..core import CLIP_MODEL_SPECS, Config
from ..ops import topk

N, K, REPS = 1_000_000, 48, 21
MODEL = "ViT-B/32"


def _timed(fn, reps: int) -> dict:
    """Host-clock ms of the calls ``fn(0)`` .. ``fn(reps - 1)`` and the
    kernel launches they made."""
    bench._zero_launches()
    ms = []
    for i in range(reps):
        t0 = time.perf_counter()
        fn(i)
        ms.append((time.perf_counter() - t0) * 1e3)
    return {"ms_p50": bench.median(ms), "n": reps, "ms": ms,
            "launches": {k: v for k, v in topk.DTYPE_LAUNCHES.items() if v}}


def measure(device, n: int = N, reps: int = REPS, model: str = MODEL) -> list[dict]:
    """The three latencies over an ``n``-row f32 store on ``device``;
    returns one dict per measurement, each with ``ok``."""
    from ..engine import SearchEngine
    from ..index.store import IndexWriter

    spec = CLIP_MODEL_SPECS[model]
    d = spec.embed_dim
    tmp = Path(tempfile.mkdtemp(prefix="serve_latency_"))
    eng = None
    try:
        cfg = Config(env_path=None)
        eng = SearchEngine(cfg=cfg, spec=spec, device=device)
        rng = np.random.default_rng(0)
        emb = rng.standard_normal((n, d), np.float32)
        emb /= np.linalg.norm(emb, axis=1, keepdims=True)
        w = IndexWriter.create(tmp, model=spec.name, dim=d, dtype_name="float32",
                               index_folder_name=cfg.INDEX_FOLDER_NAME)
        w.append(emb, [f"img_{i:07d}.jpg" for i in range(n)], [{}] * n)
        w.finalize()
        k = min(K, n)
        # first calls: the corpus's copy to the card, the text tower, the kernels
        warm = eng.search_text(str(tmp), "warmup query", k)
        lengths, own = [len(warm[1])], []

        def text(query):
            lengths.append(len(eng.search_text(str(tmp), query, k)[1]))

        def by_row(i):
            _, idx, _ = eng.search_embedding(str(tmp), emb[i % 64], k)
            lengths.append(len(idx))
            own.append(int(idx[0]) == i % 64)

        out = []
        for name, fn in (("search_text_cache_miss", lambda i: text(f"fresh query number {i:04d}")),
                         ("search_text_cache_hit", lambda i: text("warmup query")),
                         ("search_embedding", by_row)):
            row = {"measure": name, "rows": n, "store": "float32", "k": k, **_timed(fn, reps)}
            row["ok"] = all(x == k for x in lengths) and all(own)
            out.append(row)
        return out
    finally:
        if eng is not None:
            eng.close()
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("serve_latency: no CUDA device; it measures the card")
    card = bench.card_info(torch.device("cuda", torch.cuda.current_device()))
    print(f"{card['name']}, {card['power_limit']}", flush=True)
    rows = measure("cuda")
    for row in rows:
        print(json.dumps({**row, "device": card["kind"]}), flush=True)
    return 0 if all(row["ok"] for row in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
