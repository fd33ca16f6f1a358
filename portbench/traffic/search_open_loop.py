"""Traffic kind ``search_open_loop``: fresh-text ``POST /search`` over a
seeded library, in an open loop at a fixed rate.

Set-up: the towers' weights from the seed, ``photos`` photo-like JPEGs
(each row of the library points at one of them, row r at photo r mod
photos), the library of ``rows`` unit bfloat16 rows written through the
program's ``IndexWriter`` with each row's number as its ``mtime``, the
engine and its HTTP server; then every thumbnail rendered once and the
shapes the window uses warmed: the fused text->search dispatch at each
query bucket the batcher forms (1, 8, 64 queries) for each ``limit``,
HTTP requests of each limit, then ``warm_s`` seconds of the window's own
load (other texts), so that the window opens in the steady state.

The window: ``rate`` x ``seconds`` requests. Every seed gets the same
arrivals (Poisson: exponential gaps drawn once from ``base_seed``, in
one order, since the order of the gaps decides the bursts and so the
queueing) and the same set of word counts and limits, these in a seeded
order; the words are drawn from the seed, and every text is unique, so
every request misses the text cache.

The check, after the window, the peak read and the program freed: a
sample of ``sample`` requests drawn from the seed (the longest answers
among them) against the reference: its own tokens, text tower in float32
and exact top-k over the library's rows made again from the seed.
Compared: ``rank_gap``, the widest gap by which the reference score of
the row served at a rank lies below the reference's own score at that
rank; ``score_gap``, the widest difference between a served similarity
and the reference score of that row. An answer with the wrong number of
rows, a repeated row or an unknown row fails the check outright.
"""

from __future__ import annotations

import math
import time
from pathlib import Path

import numpy as np

from portbench import data, harness
from portbench.harness import Run, log

WORDS = Path(__file__).resolve().parent / "words.txt"


def schedule(params: dict, seed: int, seconds: float) -> list[list]:
    """[offset_s, text, limit] per request, by due time."""
    n = int(round(params["rate"] * seconds))
    base = np.random.default_rng(params["base_seed"])
    gaps = base.exponential(1.0, n + 1)
    gaps *= seconds / gaps.sum()
    lengths = base.integers(params["min_words"], params["max_words"] + 1, n)
    n_big = int(round(n * params["big_share"]))
    limits = np.array([params["big_limit"]] * n_big + [params["limit"]] * (n - n_big))
    rng = np.random.default_rng(data.sub_seed(seed, "schedule"))
    offsets = np.cumsum(gaps[:n])
    lengths, limits = rng.permutation(lengths), rng.permutation(limits)
    vocab = WORDS.read_text().split()
    texts, seen = [], set()
    for m in lengths:
        while True:
            text = " ".join(vocab[j] for j in rng.integers(0, len(vocab), m))
            if text not in seen:
                break
        seen.add(text)
        texts.append(text)
    return [[float(o), t, int(k)] for o, t, k in zip(offsets, texts, limits)]


def sample(reqs: list[list], size: int, seed: int) -> list[int]:
    """The requests the check reads: the longest answers with the most
    words first (an eighth of the sample), the rest drawn from the
    seed."""
    size = min(size, len(reqs))
    order = sorted(range(len(reqs)), key=lambda i: (-reqs[i][2], -len(reqs[i][1].split()), i))
    longest = order[: size // 8]
    rest = sorted(set(range(len(reqs))) - set(longest))
    rng = np.random.default_rng(data.sub_seed(seed, "sample"))
    drawn = rng.choice(len(rest), size - len(longest), replace=False)
    return sorted(longest + [rest[i] for i in drawn])


def latencies_ms(reqs: list[list], res: dict, rows: int) -> tuple[list[float], int]:
    """Each request's latency from when it was due to its last byte (a
    failed one: infinite), and the number failed: not answered 200 with
    min(limit, rows) results."""
    lat, failed = [], 0
    for i, (due, _, limit) in enumerate(reqs):
        ok = res["status"][i] == 200 and res["count"][i] == min(limit, rows)
        failed += not ok
        lat.append((res["done"][i] - due) * 1e3 if ok else math.inf)
    return lat, failed


def _warm(run: Run, engine, server, folder: str) -> None:
    params = run.traffic
    tok = engine.tokenizer
    ctx = run.model["context_length"]
    texts = iter(f"warm {i} {w}" for i, w in enumerate(WORDS.read_text().split() * 4))
    for k in sorted({params["limit"], params["big_limit"]}):
        for q in params["warm_buckets"]:
            tokens = tok.tokenize([next(texts) for _ in range(q)], ctx, truncate=tok.fallback)
            engine._execute_text_search_batch(folder, np.asarray(tokens, np.int32), k)
        for _ in range(2):
            code, _ = harness.post(server.port, "/search", {
                "folder": folder, "query": next(texts), "limit": k})
            if code != 200:
                raise RuntimeError(f"warm-up /search returned {code}")


def _spec(params: dict, server, folder: str, reqs: list, picked: list) -> dict:
    """The client's instructions for ``reqs``, due from lead_s from now."""
    return {"kind": "search", "port": server.port, "folder": folder,
            "t0": time.monotonic() + params["lead_s"], "requests": reqs, "sample": picked,
            "workers": params["workers"], "timeout_s": params["timeout_s"],
            "drain_s": params["drain_s"]}


def run(run: Run) -> dict:
    import torch

    from concurrent.futures import ThreadPoolExecutor

    from evossearch_tpu_torch.index.store import IndexWriter
    from evossearch_tpu_torch.server.thumbs import thumbnail_b64

    params, model = run.traffic, run.model
    rows, dim = params["rows"], model["embed_dim"]
    t = time.monotonic()
    photos, mean_bytes = data.write_photos(run.tmp / "photos", params["photos"], run.seed,
                                           params["photo"], params["writers"],
                                           run.device)
    log(f"{len(photos)} photos, mean {mean_bytes:.0f} bytes, {time.monotonic() - t:.1f} s")
    lib = run.tmp / "library"
    lib.mkdir()
    t = time.monotonic()
    data.write_library(lib, rows, dim, run.seed, photos, run.device, IndexWriter,
                       model["name"], run.config["engine"]["INDEX_FOLDER_NAME"])
    log(f"library of {rows} rows written in {time.monotonic() - t:.1f} s")
    weights = data.make_weights(model, run.seed, run.device)
    engine = harness.build_engine(run, weights)
    del weights
    server = harness.Server(engine, engine.cfg)
    cfg = engine.cfg
    with ThreadPoolExecutor(params["writers"]) as pool:
        list(pool.map(lambda p: thumbnail_b64(p, cfg.THUMBNAIL_SIZE, cfg.THUMBNAIL_QUALITY),
                      photos))
    folder = str(lib)
    t = time.monotonic()
    _warm(run, engine, server, folder)
    log(f"warm-up {time.monotonic() - t:.1f} s")
    if run.tamper is not None:
        run.tamper(engine)
    if run.trace:
        harness.warm_profiler()
    harness.settle()

    # the window's own load for warm_s seconds first (texts no window
    # request uses), so that the window starts in the steady state
    warm = [[o, "warm " + t, k] for o, t, k in
            schedule(params, data.sub_seed(run.seed, "warm"), params["warm_s"])]
    proc, out_path = harness.start_client(_spec(params, server, folder, warm, []), run.tmp)
    harness.finish_client(proc, out_path, params["warm_s"] + params["drain_s"] + 60)
    reqs = schedule(params, run.seed, run.seconds)
    picked = sample(reqs, params["sample"], run.seed)
    spec = _spec(params, server, folder, reqs, picked)
    t0 = spec["t0"]
    proc, out_path = harness.start_client(spec, run.tmp)
    wait = t0 - time.monotonic()
    if wait > 0:
        time.sleep(wait)
    before = harness.snapshot(engine)
    traced = None
    if run.trace:
        traced = harness.traced_subwindow(engine, t0, params["trace_offset_s"],
                                          params["trace_s"])
    res = harness.finish_client(proc, out_path, run.seconds + params["drain_s"] + 60)
    after = harness.snapshot(engine)
    card = harness.card() if run.device.startswith("cuda") else {}
    traced = harness.reduce_subwindow(run, traced)
    server.stop()
    engine.close()
    del engine, server
    import gc

    gc.collect()
    if run.device.startswith("cuda"):
        torch.cuda.empty_cache()

    lat, failed = latencies_ms(reqs, res, rows)
    late = sorted((res["sent"][i] - reqs[i][0]) * 1e3 for i in range(len(reqs)))
    log(f"{len(reqs)} requests, {failed} failed, client late p50 "
        f"{harness.percentile(late, 0.5):.3f} ms p99 {harness.percentile(late, 0.99):.3f} ms")
    t = time.monotonic()
    compared, problems = check(run, reqs, picked, res["rows"])
    log(f"check {time.monotonic() - t:.1f} s")
    return {
        "e2e": {"search_p50_ms": harness.percentile(lat, 0.50),
                "search_p95_ms": harness.percentile(lat, 0.95)},
        "t0": t0,
        "attempted": len(reqs),
        "failed": failed,
        "card": card,
        "compared": compared,
        "problems": problems,
        "ctx": {"kind": "search", "latencies_ms": lat, "window": harness.delta(before, after),
                "trace": traced, "model": model, "rows": rows, "dim": dim,
                "limits": [k for _, _, k in reqs]},
    }


def check(run: Run, reqs, picked, served: dict) -> tuple[dict, list[str]]:
    """The compared numbers of the sampled answers, and what failed
    outright."""
    from portbench.reference import topk

    params, model = run.traffic, run.model
    rows, dim = params["rows"], model["embed_dim"]
    problems = []
    got = []
    for i in picked:
        r = served.get(str(i))
        want = min(reqs[i][2], rows)
        if r is None or len(r) != want:
            problems.append(f"request {i}: {0 if r is None else len(r)} rows, not {want}")
            continue
        ids = [int(m) for m, _ in r]
        if len(set(ids)) != len(ids) or not all(0 <= x < rows and x == m for x, (m, _) in zip(ids, r)):
            problems.append(f"request {i}: repeated or unknown rows")
            continue
        got.append((i, np.array(ids), np.array([s for _, s in r])))
    if not got:
        return {"rank_gap": math.inf, "score_gap": math.inf}, problems or ["nothing to check"]
    texts = [reqs[i][1] for i, _, _ in got]
    q = reference_queries(run, texts, "fp32")
    lib = data.library_rows(rows, dim, run.seed, run.device)
    kmax = max(len(ids) for _, ids, _ in got)
    best_s, _ = topk.topk(lib, q, kmax)
    rank_gap = score_gap = 0.0
    for r, (i, ids, sims) in enumerate(got):
        ref = topk.scores(lib, q[r], ids)
        rank_gap = max(rank_gap, float(np.max(best_s[r, : len(ids)] - ref)))
        score_gap = max(score_gap, float(np.max(np.abs(sims - ref))))
    return {"rank_gap": rank_gap, "score_gap": score_gap}, problems


def reference_queries(run: Run, texts: list[str], precision: str):
    """The reference's unit query rows for ``texts``, on weights made
    again from the seed."""
    import torch

    from portbench.reference import clip, tokenizer

    model = run.model
    w = data.make_weights(model, run.seed, run.device)
    tokens = torch.as_tensor(tokenizer.tokenize(texts, model["context_length"]),
                             device=run.device)
    out = torch.cat([clip.encode_text(w, tokens[s : s + 64], model, precision)
                     for s in range(0, len(texts), 64)])
    del w
    return out
