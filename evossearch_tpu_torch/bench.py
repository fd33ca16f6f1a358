"""The port's benchmark: the JAX package's ``bench.py`` on one CUDA GPU.

    python -m evossearch_tpu_torch.bench [--phases search,sq8,...]

Runs ``bench.py``'s fourteen phases in its order and at its sizes
(``--phases`` selects some, named as the functions without ``bench_``,
and keeps that order): the headline ``search`` (1,000,000 unit f32 rows
of d = 512, 48 queries, k = 48), ``sq8`` (20,971,520 int8 rows), ``ivf``,
``index`` (1,536 JPEGs through ``index_folder``), ``hbm`` (eviction and
the SQ8 certificate's fallback), ``serve`` (8 HTTP client threads x 40
requests over a 1,000,000-row store), ``train`` (the bf16 step at 256
pairs), the towers ``encode`` (ViT-B/32, batch 512), ``encode_b16``,
``encode_l14`` and ``encode_rn50``, ``device_pipeline``, ``ivf_10m`` and
``search_10m``. Models run at full width from seeded random weights;
every input is made from a seed.

Stdout carries ONE JSON line, printed as soon as the headline is
measured: ``{"metric": "exact_top48_per_query_ms_at_1M_vectors_batch48",
"value": ms, "unit": "ms", "device": {"kind", "name", "power_limit"}}``
(the name and power limit as ``nvidia-smi --query-gpu=name,power.limit``
gives them). Everything else goes to stderr: before each phase the bytes
it finds held on the card; a line per measurement; each correctness check
as ``check <name> ok|FAILED <detail>``; after each phase one ``phase
{json}`` line (seconds, budget, bytes held before, peak bytes, launches by
kernel and corpus dtype from ``ops.topk.DTYPE_LAUNCHES``, zeroed at the
phase's start); and a closing summary of the evidence lines.

Timing. A phase whose result stays on the card (the towers, the train
step, the SQ8 select) is timed with CUDA events around each of many
launches after a warm-up; a phase whose result the caller gets on the
host (the searches, the HTTP requests) by the host clock around a call
that ends in the copy to the host. Every timing gives its median and its
sample count, and from 21 samples the highest whole percentile that has
at least ten samples above it.

Correctness is checked in the run: the headline's and the sweeps' results
against a float64 oracle computed here (scores and returned rows within
the routes' error bound of the oracle's, ids equal wherever its
neighbouring scores are clear of that bound: ``agreement``), SQ8
certified results against the dequantized oracle, IVF recall@48 >= 0.99,
every HTTP request 200, the indexed count, the decode route and the
copied canvas bytes, the eviction and fallback counts, finite losses and
embeddings, and ViT-L/14 on the card against the CPU.

Exit code: 0 when every selected phase ran within its budget and every
check passed, else 1, after every selected phase has run. Without a CUDA
device ``main()`` raises: the phases run on the CPU only in the tests,
which pass ``device="cpu"`` and shrink the module's sizes.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from .core import CLIP_MODEL_SPECS, Config
from .index import search as index_search
from .ops import topk
from .utils.profiling import capture_trace

# -- sizes: bench.py's, module-level so the tests can shrink them ----------

N_VECTORS = 1_000_000
DIM = 512
K = 48
QUERY_BATCH = 48
ITERS = 20
MODEL = "ViT-B/32"  # the model of index, hbm, serve, train, device_pipeline

SWEEP_ROWS = 10_000_000  # search_10m's bf16 corpus
SWEEP_ITERS = 8
SQ8_ROWS, SQ8_CHUNK, SQ8_FETCH = 20 << 20, 1 << 19, 512
SQ8_TILE = topk.SQ8_TILE_ROWS
IVF_ROWS, IVF_LISTS, IVF_ITERS, IVF_QUERIES = 1_000_000, 1000, 10, 32
IVF3_ROWS, IVF3_LISTS, IVF3_ITERS, IVF3_CHUNK = 3_000_000, 1732, 6, 250_000
IVF3_FACTOR = 1.5
IVF10_ROWS = 10_000_000  # the one-card feasibility reckoning only
HOST_IVF_ROWS, HOST_IVF_LISTS, HOST_IVF_QUERIES = 150_000, 400, 16
INDEX_IMAGES = 1536
PHOTO = (480, 640)  # the synthetic photos' height and width
HBM_ROWS, HBM_CHUNK = 300_000, 1 << 16
HBM_BUDGETS_MB = (480, 4)  # the two-folder engine's, the tie folder's
TIE_ROWS = 7000  # the tie folder: every even row the same
SERVE_ROWS, SERVE_CHUNK = 1_000_000, 1 << 17
SERVE_THREADS, SERVE_PER_THREAD = 8, 40
TRAIN_BATCH, TRAIN_REPS = 256, 10
# phase -> (model, batch, timed launches)
ENCODE = {
    "encode": ("ViT-B/32", 512, 20),
    "encode_b16": ("ViT-B/16", 128, 16),
    "encode_l14": ("ViT-L/14", 64, 10),
    "encode_rn50": ("RN50", 128, 16),
}
L14_CHECK_IMAGES = 4
PIPELINE_BATCH, PIPELINE_REPS = 128, 12

# Queries of the subset the sweeps' oracle checks (the headline checks all).
ORACLE_QUERIES = 8
# Rows per float64 block of the oracles.
ORACLE_ROWS = 1 << 18

# Seconds each phase may take (bench.py's budgets); over it, the phase fails.
BUDGETS_S = {"search": 420, "sq8": 600, "ivf": 420, "index": 600, "hbm": 600,
             "serve": 600, "train": 480, "encode": 480, "ivf_10m": 600}
DEFAULT_BUDGET_S = 300

METRIC = "exact_top48_per_query_ms_at_1M_vectors_batch48"
# NVIDIA's published dense bf16 peak of one H100 SXM at 700 W.
H100_PEAK_BF16_FLOPS = 989e12
# The SQ8 tie folder's query: its plateau row plus this much Gaussian noise
TIE_NOISE = 1e-5


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class PhaseOverBudget(RuntimeError):
    pass


class Run:
    """One bench run: the device, the evidence lines, the failed checks
    and phases, and the deadline of the phase running now."""

    def __init__(self, device):
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.cuda = self.device.type == "cuda"
        self.lines: list[str] = []
        self.failures: list[str] = []
        self.phase = ""
        self.deadline = math.inf
        self._card: dict | None = None

    @property
    def card(self) -> dict:
        """The device's name and power limit (``nvidia-smi``'s words)."""
        if self._card is None:
            self._card = card_info(self.device)
        return self._card

    def summary(self, msg: str) -> None:
        """An evidence line: logged now and repeated in the closing summary."""
        log(msg)
        self.lines.append(msg)

    def check(self, name: str, ok: bool, detail="") -> bool:
        log(f"check {name} {'ok' if ok else 'FAILED'} {detail}")
        if not ok:
            self.failures.append(f"check {name}")
        return ok

    def step(self, what: str) -> None:
        """Called after each step of a phase: a phase past its budget
        stops here and fails (a Python signal cannot stop a blocking CUDA
        call, so the clock is read between steps)."""
        log(f"[{self.phase}] {what}")
        if time.perf_counter() > self.deadline:
            raise PhaseOverBudget(f"{self.phase}: over its budget after {what}")

    def generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)


def card_info(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"kind": "cpu"}
    info = {"kind": torch.cuda.get_device_name(device), "name": None,
            "power_limit": None}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
             f"--id={device.index or 0}"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip()
        name, limit = (part.strip() for part in out.splitlines()[0].rsplit(",", 1))
        info.update(name=name, power_limit=limit)
    except (OSError, subprocess.SubprocessError, ValueError) as e:
        log(f"nvidia-smi not read: {e!r}")
    return info


def card_words(run: Run) -> str:
    card = run.card
    if not run.cuda:
        return "on the CPU"
    return f"on {card['name'] or card['kind']}, {card['power_limit'] or 'power limit not read'}"


# -- timing ---------------------------------------------------------------


def timing(samples) -> str:
    """Median and sample count; from 21 samples also the highest whole
    percentile with at least ten samples above it (at 20 it is the
    median)."""
    a = np.asarray(samples, np.float64)
    n = len(a)
    out = f"p50 {np.percentile(a, 50):.4f} ms (n={n})"
    p = math.floor(100 * (n - 10) / n) if n >= 20 else 50
    if p > 50:  # at 20 samples that percentile is the median
        out += f", p{p} {np.percentile(a, p):.4f} ms"
    return out


def host_ms(fn, iters: int) -> list[float]:
    """Host-clock ms of ``fn`` per call; ``fn`` ends in a copy to the host."""
    out = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def device_ms(run: Run, fn, reps: int, warmup: int = 3) -> list[float]:
    """ms of each of ``reps`` launches of ``fn`` after ``warmup``: CUDA
    events around each launch on the card (the host clock on the CPU)."""
    for _ in range(warmup):
        fn()
    if not run.cuda:
        return host_ms(fn, reps)
    torch.cuda.synchronize(run.device)
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize(run.device)
    return [s.elapsed_time(e) for s, e in pairs]


def median(samples) -> float:
    return float(np.percentile(np.asarray(samples, np.float64), 50))


# -- data -----------------------------------------------------------------


def unit_rows(n: int, d: int, gen: torch.Generator, device, dtype=torch.float32,
              chunk: int = 1 << 20) -> torch.Tensor:
    """``n`` Gaussian rows scaled to unit norm, in ``dtype``, made chunk by
    chunk on ``device`` (no f32 copy of a bf16 corpus)."""
    out = torch.empty((n, d), dtype=dtype, device=device)
    for start in range(0, n, chunk):
        x = torch.randn(min(chunk, n - start), d, generator=gen, device=device)
        out[start : start + x.shape[0]] = x / torch.linalg.norm(x, dim=1, keepdim=True)
    return out


def chunk_generator(seed: int, chunk: int, device) -> torch.Generator:
    """The generator of one chunk of a corpus made chunk by chunk: seeded by
    (seed, chunk), so a chunk is made again alone by the same call."""
    return torch.Generator(device=device).manual_seed((seed << 32) + chunk)


def clustered_rows(n: int, d: int, lists: int, seed: int, device,
                   dtype=torch.float32, chunk: int = 1 << 20) -> torch.Tensor:
    """bench.py's IVF corpus: Gaussian centres, each row a random centre
    plus 0.25 Gaussian noise, scaled to unit norm, made chunk by chunk."""
    centres = torch.randn(lists, d, generator=torch.Generator(device=device)
                          .manual_seed(seed), device=device)
    out = torch.empty((n, d), dtype=dtype, device=device)
    for c, start in enumerate(range(0, n, chunk)):
        gen = chunk_generator(seed, c, device)
        m = min(chunk, n - start)
        e = centres[torch.randint(0, lists, (m,), generator=gen, device=device)]
        e = e + 0.25 * torch.randn(m, d, generator=gen, device=device)
        out[start : start + m] = e / torch.linalg.norm(e, dim=1, keepdim=True)
    return out


def noisy_queries(emb: torch.Tensor, count: int, rng: np.random.Generator) -> np.ndarray:
    """Corpus rows plus 0.05 Gaussian noise, unit norm (bench.py's IVF
    queries and the nprobe calibration's distribution)."""
    rows = torch.from_numpy(rng.integers(0, emb.shape[0], count)).to(emb.device)
    qs = emb[rows].float().cpu().numpy()
    qs += 0.05 * rng.standard_normal(qs.shape).astype(np.float32)
    return qs / np.linalg.norm(qs, axis=1, keepdims=True)


# -- the oracles ----------------------------------------------------------


def oracle_topk(emb: torch.Tensor, queries: torch.Tensor, k: int):
    """The exact top ``k + 1`` of each query in float64, under the tie
    contract (score desc, row asc): float64 products of the stored rows
    (a bf16 row widened exactly) with ``queries`` as given, block by block,
    each block ranked by a stable descending sort, the blocks' heads merged
    by a lexicographic sort. Returns numpy (scores (Q, k+1) f64, rows
    (Q, k+1) int64)."""
    q = queries.to(device=emb.device, dtype=torch.float64)
    parts_s, parts_i = [], []
    for start in range(0, emb.shape[0], ORACLE_ROWS):
        s = q @ emb[start : start + ORACLE_ROWS].double().T
        top, pos = torch.sort(s, dim=1, descending=True, stable=True)
        kk = min(k + 1, s.shape[1])
        parts_s.append(top[:, :kk].cpu())
        parts_i.append(pos[:, :kk].cpu() + start)
        del s, top, pos
    cs = torch.cat(parts_s, 1).numpy()
    ci = torch.cat(parts_i, 1).numpy()
    order = np.lexsort((ci, -cs))[:, : k + 1]
    return np.take_along_axis(cs, order, 1), np.take_along_axis(ci, order, 1)


def exact_scores(emb: torch.Tensor, queries: torch.Tensor, ids: np.ndarray):
    """float64 dots and sum_k |x_k * q_k| of each (query, row) pair in
    ``ids``, as numpy (Q, m) arrays."""
    q = queries.to(device=emb.device, dtype=torch.float64)
    rows = emb[torch.from_numpy(ids.reshape(-1)).to(emb.device)].double()
    p = rows.reshape(*ids.shape, -1) * q[:, None, :]
    return p.sum(-1).cpu().numpy(), p.abs().sum(-1).cpu().numpy()


def agreement(s: np.ndarray, i: np.ndarray, emb: torch.Tensor,
              queries: torch.Tensor, unit: float) -> dict:
    """A search result against ``oracle_topk`` on the same rows and
    queries (the queries as the route scores them: bf16-rounded for a
    bf16 corpus). With tol = ``unit * sum|x*q|`` (the largest sum over the
    query's oracle and returned rows): every score lies within tol of the
    oracle's at its rank; every returned row is distinct and its float64
    score lies within 2 tol of the oracle's at its rank; and the ids equal
    the oracle's at every rank whose oracle score lies more than 2 tol
    from its neighbours' (the (k+1)-th included). Only a near-tie may
    order by rounding."""
    k = s.shape[1]
    i = np.asarray(i, np.int64)
    o_s, o_i = oracle_topk(emb, queries, k)
    got, got_abs = exact_scores(emb, queries, i)
    sums = np.maximum(exact_scores(emb, queries, o_i)[1].max(1), got_abs.max(1))
    tol = unit * sums[:, None]
    err = np.abs(np.asarray(s, np.float64) - o_s[:, :k])
    gap = o_s[:, :-1] - o_s[:, 1:]  # rank r to r+1, (Q, k)
    near = gap.copy()
    near[:, 1:] = np.minimum(gap[:, 1:], gap[:, :-1])
    clear = near > 2 * tol
    distinct = (np.diff(np.sort(i, 1), axis=1) != 0).all(1)
    rows_ok = (((i == o_i[:, :k]) | ~clear) & (np.abs(got - o_s[:, :k]) <= 2 * tol)).all(1)
    ids_ok = rows_ok & distinct
    scores_ok = (err <= tol).all(1)
    return {"ok": bool((ids_ok & scores_ok).all()),
            "matching": int((ids_ok & scores_ok).sum()), "queries": int(len(ids_ok)),
            "rows_agree": bool(ids_ok.all()),
            "scores_within_bound": bool(scores_ok.all()),
            "score_err_over_bound_max": float((err / tol).max()),
            "ranks_clear": int(clear.sum()), "ranks": int(clear.size)}


def err_unit(dtype, d: int) -> float:
    """The score error bound of the search routes over a corpus of
    ``dtype`` and width ``d``, in units of sum_k |x_k * q_k|
    (ops/csrc/topk_tc.cuh): an f32 corpus in three TF32 passes; a bf16
    corpus against bf16 queries, exact products and a truncating f32
    accumulation. The dense path's cuBLAS products stay within both."""
    if dtype == torch.float32:
        return 2.0 ** -19 + 2 * d * 2.0 ** -24
    return 2 * d * 2.0 ** -24


def bf16_queries(queries: torch.Tensor) -> torch.Tensor:
    """Queries as a bf16 corpus is scored against them."""
    return queries.float().to(torch.bfloat16).float()


def dequant_scores(e8_rows: torch.Tensor, scale: torch.Tensor,
                   qb: torch.Tensor) -> torch.Tensor:
    """``scale_i * <e8_i, q~>`` in float64, (Q, m), for int8 rows (m, d)
    with their scales (m,) and queries q~ (Q, d) already rounded to bf16.
    Each product of an int8 and a bf16 value holds at most 15 significant
    bits, so while a query's nonzero values span at most 2^28
    (``exactly_summable``) every sum is exact in float64 and the score is
    the same in any order of summation: the oracle's sweep and the
    rerank's gather give equal numbers."""
    return (qb.double() @ e8_rows.double().T) * scale.double()


def exactly_summable(qb: torch.Tensor) -> bool:
    """Whether every query's nonzero values span at most 2^28, so
    ``dequant_scores`` is exact (15-bit products, 512 terms: 15 + 28 + 10
    bits fit float64's 53)."""
    a = qb.abs().double()
    lo = torch.where(a > 0, a, torch.full_like(a, math.inf)).amin(1)
    return bool((a.amax(1) <= lo * 2.0 ** 28).all())


def sq8_corpus(n: int, chunk: int, seed: int, device, normalize: bool):
    """An int8 corpus quantized on the device chunk by chunk
    (``index.sq8.quantize_rows_device``): Gaussian rows, scaled to unit
    norm when ``normalize``, rounded to bf16 (as a bf16 store holds them);
    chunk c's rows come from ``chunk_generator(seed, c)``. Returns (e8
    (n, d) int8, scal2 (2, n) f32)."""
    from .index.sq8 import quantize_rows_device

    e8 = torch.empty((n, DIM), dtype=torch.int8, device=device)
    scal2 = torch.empty((2, n), dtype=torch.float32, device=device)
    for c, start in enumerate(range(0, n, chunk)):
        m = min(chunk, n - start)
        rows = torch.randn(m, DIM, generator=chunk_generator(seed, c, device),
                           device=device)
        if normalize:
            rows = rows / torch.linalg.norm(rows, dim=1, keepdim=True)
        q8, sc = quantize_rows_device(rows.to(torch.bfloat16).float())
        e8[start : start + m] = q8
        scal2[:, start : start + m] = sc
        del rows, q8, sc
    return e8, scal2


def sq8_oracle(e8: torch.Tensor, scal2: torch.Tensor, qb: torch.Tensor, k: int):
    """The dequantized corpus's exact top-k (``dequant_scores``), block by
    block, under (score desc, row asc). Returns numpy (scores f64, rows)."""
    parts_s, parts_i = [], []
    for start in range(0, e8.shape[0], ORACLE_ROWS):
        blk = e8[start : start + ORACLE_ROWS]
        s = dequant_scores(blk, scal2[0, start : start + blk.shape[0]], qb)
        top, pos = torch.sort(s, dim=1, descending=True, stable=True)
        parts_s.append(top[:, :k].cpu())
        parts_i.append(pos[:, :k].cpu() + start)
        del s, top, pos
    cs = torch.cat(parts_s, 1).numpy()
    ci = torch.cat(parts_i, 1).numpy()
    order = np.lexsort((ci, -cs))[:, :k]
    return np.take_along_axis(cs, order, 1), np.take_along_axis(ci, order, 1)


def sq8_certified(e8: torch.Tensor, scal2: torch.Tensor, queries: torch.Tensor,
                  fetch: int, k: int):
    """The SQ8 tier's device half (``index.sq8._sq8_select``: the bound
    sweep, the top-``fetch`` bounds and the counting certificate) with the
    rerank against the dequantized rows (``dequant_scores``) in place of
    the store's, certified as ``SQ8Index.search_batch`` certifies. Returns
    (scores (Q, k) f64, rows (Q, k), certified (Q,) bool) as numpy."""
    from .index.sq8 import _sq8_select

    n = e8.shape[0]
    c_total = -(-n // SQ8_TILE) * 2 * topk.TREE_CLASSES
    fetch = min(max(fetch, k + 32), c_total)
    fb, fid, cnt_ok, m3max = _sq8_select(e8, scal2, queries, fetch, SQ8_TILE)
    finite = torch.isfinite(fb) & (fb > topk.NEG_INF / 2)
    fid = torch.where(finite, fid, torch.zeros_like(fid))
    qb = bf16_queries(queries)
    rr = torch.stack([dequant_scores(e8[fid[q]], scal2[0][fid[q]], qb[q : q + 1])[0]
                      for q in range(fid.shape[0])])
    rr = torch.where(finite, rr, torch.full_like(rr, -math.inf)).cpu().numpy()
    ids = fid.cpu().numpy()
    order = np.lexsort((ids, -rr))[:, :k]
    s = np.take_along_axis(rr, order, 1)
    i = np.take_along_axis(ids, order, 1)
    m = s[:, -1]
    mf = fb[:, -1].double().cpu().numpy()
    cert = ((m3max.double().cpu().numpy() < m)
            & (fetch == c_total or (cnt_ok.cpu().numpy() & (m >= mf))))
    return s, i, cert & np.isfinite(m)


def sq8_verdict(s, i, cert, o_s, o_i) -> dict:
    """Certified queries against the dequantized oracle: rows equal and
    scores equal (both are exact, ``dequant_scores``)."""
    match = np.array([np.array_equal(i[q], o_i[q]) and np.array_equal(s[q], o_s[q])
                      for q in range(len(cert))])
    return {"certified": int(cert.sum()), "matching": int((match & cert).sum()),
            "queries": int(len(cert)), "ok": bool(match[cert].all())}


# -- FLOPs (bench.py's convention: matmuls only, 2 per multiply-add) ------


def _vit_fwd_flops(spec) -> float:
    """Forward FLOPs per image of a ViT image tower: QKVO, attention and
    MLP products per layer, the patch embedding and the projection."""
    t = spec.num_image_tokens
    w = spec.vision_width
    per_layer = 24 * t * w * w + 4 * t * t * w
    patch = 2 * t * (spec.patch_size**2 * 3) * w
    proj = 2 * w * spec.embed_dim
    return spec.vision_layers * per_layer + patch + proj


def _resnet_fwd_flops(spec) -> float:
    """Forward FLOPs per image of a modified-ResNet image tower: the convs
    and the attention pool's projections."""
    s = spec.image_size // 2  # stem convs run at half resolution
    w = spec.vision_width
    f = (2 * s * s * 9 * 3 * (w // 2)
         + 2 * s * s * 9 * (w // 2) * (w // 2)
         + 2 * s * s * 9 * (w // 2) * w)
    s //= 2  # stem avg pool
    cin = w
    for i, n_blocks in enumerate(spec.vision_layers):
        planes = w * (2 ** i)
        stride = 1 if i == 0 else 2
        s_out = s // stride
        for b in range(n_blocks):
            c_in = cin if b == 0 else planes * 4
            sp_in = s if b == 0 else s_out
            f += 2 * sp_in * sp_in * c_in * planes  # conv1 1x1
            f += 2 * sp_in * sp_in * 9 * planes * planes  # conv2 3x3
            f += 2 * s_out * s_out * planes * planes * 4  # conv3 1x1
            if b == 0:
                f += 2 * s_out * s_out * c_in * planes * 4  # shortcut conv
        cin, s = planes * 4, s_out
    C, T = spec.attn_dim, spec.num_image_tokens
    f += 2 * C * C + 2 * 2 * T * C * C  # q (1 token) + k/v projections
    f += 2 * C * spec.embed_dim  # c_proj
    return f


def _text_fwd_flops(spec) -> float:
    """Forward FLOPs per caption of the text tower, as ``_vit_fwd_flops``
    counts a ViT's (the projection of the pooled token only)."""
    t, w = spec.context_length, spec.text_width
    return spec.text_layers * (24 * t * w * w + 4 * t * t * w) + 2 * w * spec.embed_dim


def image_fwd_flops(spec) -> float:
    return (_resnet_fwd_flops if getattr(spec, "family", "vit") == "resnet"
            else _vit_fwd_flops)(spec)


def mfu_words(run: Run, flops_per_s: float) -> str:
    if not run.cuda:
        return "MFU not measured on the CPU"
    return (f"{flops_per_s / H100_PEAK_BF16_FLOPS:.1%} MFU of the H100's "
            f"{H100_PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s dense bf16 peak, "
            f"{card_words(run)}")


# -- phases ---------------------------------------------------------------


def _attribution(counts: dict, calls: int) -> str:
    if counts["kernel"] == calls and counts["fetch"] == calls and not counts["fallback"]:
        return "1 kernel + 1 copy to the host per query, no fallback"
    if not any(counts.values()):
        return "uncounted route (the dense path below 2^18 rows or on the CPU)"
    return (f"EXTRA round trips: {counts['kernel']} kernels, {counts['fetch']} "
            f"copies, {counts['fallback']} fallbacks over {calls} queries")


def bench_search(run: Run) -> dict:
    """The headline: exact top-48 of 48 unit queries over 1,000,000 unit
    f32 rows of d = 512 (``best_exact_search_batch``, host arrays out),
    p50 of 20 calls / 48; a single query's wall with its dispatch counts;
    the batch's results against the float64 oracle."""
    emb = unit_rows(N_VECTORS, DIM, run.generator(0), run.device)
    queries = unit_rows(QUERY_BATCH, DIM, run.generator(1), run.device)
    q1 = queries[:1].clone()
    index_search.best_exact_search_batch(emb, queries, K)
    index_search.best_exact_search_batch(emb, q1, K)
    run.step("warm-up")
    last: dict = {}

    def batch_call():
        last["result"] = index_search.best_exact_search_batch(emb, queries, K)

    batch = host_ms(batch_call, ITERS)
    run.step("batch timed")
    before = index_search.dispatch_counts_snapshot()
    single = host_ms(lambda: index_search.best_exact_search_batch(emb, q1, K), ITERS)
    after = index_search.dispatch_counts_snapshot()
    counts = {key: after[key] - before[key] for key in after}
    run.step("single query timed")
    s, i = last["result"]
    verdict = agreement(s, i, emb, queries, err_unit(emb.dtype, DIM))
    run.check("search_oracle", verdict["ok"], json.dumps(verdict))
    per_query = median(batch) / QUERY_BATCH
    run.summary(f"search {N_VECTORS} f32 rows, batch {QUERY_BATCH}, k={K}: "
                f"{timing(batch)} -> {per_query:.5f} ms/query {card_words(run)}")
    run.summary(f"search single query: {timing(single)}; dispatch counts "
                f"{counts} ({_attribution(counts, ITERS)})")
    return {"per_query_ms": per_query, "scores": s, "ids": i}


def bench_search_10m(run: Run) -> None:
    """10,000,000 Gaussian bf16 rows (10.24 GB) and 48 Gaussian f32
    queries, p50 of 8 calls; then its first 1,000,000 rows (the default
    store dtype at the headline's size); each against the oracle on
    ORACLE_QUERIES queries."""
    gen = run.generator(3)
    emb = torch.empty((SWEEP_ROWS, DIM), dtype=torch.bfloat16, device=run.device)
    for start in range(0, SWEEP_ROWS, 1 << 20):
        m = min(1 << 20, SWEEP_ROWS - start)
        emb[start : start + m] = torch.randn(m, DIM, generator=gen, device=run.device)
    queries = torch.randn(QUERY_BATCH, DIM, generator=run.generator(4), device=run.device)
    run.step("corpus made")
    for name, corpus in ((f"{SWEEP_ROWS} bf16", emb),
                         (f"{min(N_VECTORS, SWEEP_ROWS)} bf16 (the default store dtype)",
                          emb[:N_VECTORS])):
        index_search.best_exact_search_batch(corpus, queries, K)
        last: dict = {}

        def call():
            last["result"] = index_search.best_exact_search_batch(corpus, queries, K)

        ms = host_ms(call, SWEEP_ITERS)
        s, i = last["result"]
        sub = slice(0, ORACLE_QUERIES)
        verdict = agreement(s[sub], i[sub], corpus, bf16_queries(queries[sub]),
                            err_unit(corpus.dtype, DIM))
        run.check(f"search_10m_oracle[{corpus.shape[0]}]", verdict["ok"], json.dumps(verdict))
        run.summary(f"search {name} rows, batch {QUERY_BATCH}: {timing(ms)} -> "
                    f"{median(ms) / QUERY_BATCH:.5f} ms/query {card_words(run)}")
        run.step(f"{corpus.shape[0]} rows timed")


def bench_sq8(run: Run) -> None:
    """The SQ8 capacity tier's device half at 20,971,520 rows: an int8
    corpus quantized on the card (10.7 GB; its bf16 original would be
    21.5 GB), the select (bound sweep, top 512 bounds, certificate) timed
    with CUDA events, the candidates reranked against the dequantized rows
    and certified; every certified query must equal the dequantized
    oracle."""
    t0 = time.perf_counter()
    e8, scal2 = sq8_corpus(SQ8_ROWS, SQ8_CHUNK, 20, run.device, normalize=False)
    run.sync()
    run.summary(f"SQ8: {SQ8_ROWS} int8 rows quantized on the device in "
                f"{time.perf_counter() - t0:.3f} s (n=1; {e8.numel() / 2**30:.2f} GiB, "
                f"bf16 would be {2 * e8.numel() / 2**30:.2f} GiB)")
    queries = unit_rows(QUERY_BATCH, DIM, run.generator(21), run.device)
    run.step("corpus made")
    from .index.sq8 import _sq8_select

    ms = device_ms(run, lambda: _sq8_select(e8, scal2, queries, SQ8_FETCH, SQ8_TILE), 20)
    run.step("select timed")
    s, i, cert = sq8_certified(e8, scal2, queries, SQ8_FETCH, K)
    qb = bf16_queries(queries)
    o_s, o_i = sq8_oracle(e8, scal2, qb, K)
    verdict = sq8_verdict(s, i, cert, o_s, o_i)
    run.check("sq8_certified_equal_oracle", verdict["ok"] and exactly_summable(qb),
              json.dumps(verdict))
    gbps = SQ8_ROWS * (DIM + 8) / (median(ms) * 1e-3) / 1e9
    run.summary(f"SQ8 {SQ8_ROWS} rows exact, batch {QUERY_BATCH}: select {timing(ms)} "
                f"= {median(ms) / QUERY_BATCH:.5f} ms/query ({gbps:.1f} GB/s of int8 "
                f"rows and scalars), certified {verdict['certified']}/{QUERY_BATCH}, "
                f"equal to the oracle {verdict['matching']} {card_words(run)}")


def bench_ivf(run: Run) -> None:
    """IVF at 1,000,000 clustered f32 rows (1,000 centres): build (k-means,
    10 iterations, the nprobe calibration), recall@48 of 32 noisy queries
    against the exact path (>= 0.99), single-query and batched ms."""
    from .index.ivf import IVFIndex

    rng = np.random.default_rng(0)
    emb = clustered_rows(IVF_ROWS, DIM, IVF_LISTS, 0, run.device)
    run.step("corpus made")
    t0 = time.perf_counter()
    ivf = IVFIndex.build(emb, nlist=IVF_LISTS, iters=IVF_ITERS)
    run.sync()
    build_s = time.perf_counter() - t0
    run.step("built")
    qs = noisy_queries(emb, IVF_QUERIES, rng)
    _, exact_i = index_search.exact_search_batch(emb, qs, K)
    ivf.search(qs[0], K)
    hits, single = 0, []
    for row, q in enumerate(qs):
        t0 = time.perf_counter()
        _, i = ivf.search(q, K)
        single.append((time.perf_counter() - t0) * 1e3)
        hits += len(set(i.tolist()) & set(exact_i[row].tolist()))
    recall = hits / (len(qs) * K)
    ivf.search_batch(qs, K)
    batch = host_ms(lambda: ivf.search_batch(qs, K), 8)
    run.check("ivf_recall", recall >= 0.99, f"recall@{K}={recall:.4f} (>= 0.99)")
    run.summary(f"IVF {IVF_ROWS} f32 rows (nlist={IVF_LISTS}): build {build_s:.3f} s (n=1) "
                f"{ {k: round(v, 3) for k, v in ivf.build_s.items()} }, recall@{K}="
                f"{recall:.4f}, tuned nprobe {ivf.tuned_nprobe}; single query "
                f"{timing(single)}; batch {len(qs)} {timing(batch)} {card_words(run)}")


def bench_ivf_10m(run: Run) -> None:
    """Whether IVF beats the exact sweep on one card: (1) the 10,000,000-row
    bf16 IVF's memory against the card's (reckoned, not built); (2) at
    3,000,000 clustered bf16 rows (1,732 lists, bucket factor 1.5), IVF
    against the exact sweep on 48 queries, recall@48 >= 0.99, the exact
    side against the oracle; (3) the host crossover at 150,000 f32 rows
    (numpy scan against the IVF probe), recall@48 >= 0.99."""
    from .index.ivf import IVFIndex

    corpus_b = IVF10_ROWS * DIM * 2
    steady = int(IVF3_FACTOR * corpus_b)
    peak = corpus_b + steady
    if run.cuda:
        free, total = torch.cuda.mem_get_info(run.device)
        words = (f"the card's {total / 2**30:.2f} GiB ({free / 2**30:.2f} GiB free) "
                 f"-> {'fits' if peak <= free else 'does not fit'} on one card")
    else:
        words = "no card to hold it against"
    run.summary(f"IVF {IVF10_ROWS} bf16 rows on one card: buckets {steady / 2**30:.2f} GiB "
                f"(factor {IVF3_FACTOR}), build peak {peak / 2**30:.2f} GiB, against {words}")

    rng_q = np.random.default_rng(8)
    emb = clustered_rows(IVF3_ROWS, DIM, IVF3_LISTS, 7, run.device, torch.bfloat16,
                         chunk=IVF3_CHUNK)
    queries = torch.from_numpy(noisy_queries(emb, QUERY_BATCH, rng_q)).to(run.device)
    run.step("3M corpus made")
    t0 = time.perf_counter()
    ivf = IVFIndex.build(emb, nlist=IVF3_LISTS, iters=IVF3_ITERS,
                         bucket_factor=IVF3_FACTOR, pre_normalized=True)
    run.sync()
    build_s = time.perf_counter() - t0
    run.step("3M built")
    index_search.best_exact_search_batch(emb, queries, K)
    last: dict = {}

    def exact_call():
        last["result"] = index_search.best_exact_search_batch(emb, queries, K)

    exact_ms = host_ms(exact_call, 8)
    ivf.search_batch(queries, K)
    ivf_ms = host_ms(lambda: ivf.search_batch(queries, K), 8)
    s, exact_i = last["result"]
    _, ivf_i = ivf.search_batch(queries, K)
    hits = sum(len(set(ivf_i[r].tolist()) & set(exact_i[r].tolist()))
               for r in range(QUERY_BATCH))
    recall = hits / (QUERY_BATCH * K)
    sub = slice(0, ORACLE_QUERIES)
    verdict = agreement(s[sub], exact_i[sub], emb, bf16_queries(queries[sub]),
                        err_unit(emb.dtype, DIM))
    run.check("ivf_10m_exact_oracle", verdict["ok"], json.dumps(verdict))
    run.check("ivf_10m_recall", recall >= 0.99, f"recall@{K}={recall:.4f} (>= 0.99)")
    winner = "IVF" if median(ivf_ms) < median(exact_ms) else "EXACT"
    run.summary(f"IVF {IVF3_ROWS} bf16 rows (nlist={IVF3_LISTS}, factor={IVF3_FACTOR}, "
                f"tuned nprobe={ivf.tuned_nprobe}): build {build_s:.3f} s (n=1), recall@{K}="
                f"{recall:.4f}; batch {QUERY_BATCH}: IVF {timing(ivf_ms)}, exact "
                f"{timing(exact_ms)} -> {winner} is faster {card_words(run)}")
    del ivf, emb, queries, last
    gc.collect()
    if run.cuda:
        torch.cuda.empty_cache()
    run.step("3M freed")

    rng = np.random.default_rng(0)
    centres = rng.standard_normal((HOST_IVF_LISTS, DIM)).astype(np.float32)
    emb_h = centres[rng.integers(0, HOST_IVF_LISTS, HOST_IVF_ROWS)] + 0.25 * (
        rng.standard_normal((HOST_IVF_ROWS, DIM)).astype(np.float32))
    emb_h /= np.linalg.norm(emb_h, axis=1, keepdims=True)
    t0 = time.perf_counter()
    hivf = IVFIndex.build(emb_h, nlist=HOST_IVF_LISTS, iters=6, pre_normalized=True,
                          device="cpu")
    hbuild_s = time.perf_counter() - t0
    run.step("host IVF built")
    qs = emb_h[rng.integers(0, HOST_IVF_ROWS, HOST_IVF_QUERIES)] + 0.05 * (
        rng.standard_normal((HOST_IVF_QUERIES, DIM)).astype(np.float32))
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)

    def host_exact(q):
        # the production host scan's selection cost: argpartition and a
        # k-sized tie sort, not a full sort
        s = emb_h @ q
        part = np.argpartition(-s, K - 1)[:K]
        return part[np.lexsort((part, -s[part]))]

    hivf.search_host(qs[0], K)
    exact_sets, ivf_sets, hx, hi = [], [], [], []
    for q in qs:
        t0 = time.perf_counter()
        exact_sets.append(set(host_exact(q).tolist()))
        t1 = time.perf_counter()
        ivf_sets.append(set(hivf.search_host(q, K)[1].tolist()))
        hx.append((t1 - t0) * 1e3)
        hi.append((time.perf_counter() - t1) * 1e3)
    hrecall = sum(len(a & b) for a, b in zip(exact_sets, ivf_sets)) / (len(qs) * K)
    run.check("ivf_10m_host_recall", hrecall >= 0.99, f"recall@{K}={hrecall:.4f} (>= 0.99)")
    run.summary(f"host crossover at {HOST_IVF_ROWS} f32 rows ({os.cpu_count()} host "
                f"cores, build {hbuild_s:.3f} s (n=1) on the CPU): exact scan {timing(hx)}, "
                f"IVF probe {timing(hi)} ({median(hx) / max(median(hi), 1e-9):.2f}x, "
                f"recall@{K}={hrecall:.4f}, nprobe {hivf.tuned_nprobe})")


def _write_photos(folder: Path, count: int, base: np.ndarray, vary: bool) -> list[str]:
    """JPEG q85 photos of ``base``, each rolled sideways and tagged in one
    pixel when ``vary`` (bench.py's cheap per-image variation)."""
    from PIL import Image

    paths = []
    for i in range(count):
        arr = base
        if vary:
            arr = np.roll(base, shift=i * 7, axis=1)
            arr[0, 0] = (i & 255, (i >> 8) & 255, 0)
        path = folder / f"img_{i:05d}.jpg"
        Image.fromarray(arr).save(path, quality=85)
        paths.append(str(path))
    return paths


def _copy_probe(run: Run, canvases: list[np.ndarray], reps: int = 6) -> dict:
    """MB/s of copying one indexing batch's canvases to the card, from
    pageable and from pinned host memory, ``reps`` times each, host clock
    to a synchronize."""
    out = {}
    nbytes = sum(c.nbytes for c in canvases) * reps
    for kind in ("pageable", "pinned"):
        src = [torch.from_numpy(c) for c in canvases]
        if kind == "pinned":
            src = [t.pin_memory() for t in src]
        torch.cuda.synchronize(run.device)
        t0 = time.perf_counter()
        for _ in range(reps):
            for t in src:
                t.to(run.device, non_blocking=kind == "pinned")
        torch.cuda.synchronize(run.device)
        out[f"{kind}_MB_per_s"] = round(nbytes / (time.perf_counter() - t0) / 1e6, 1)
    return out


def bench_index(run: Run) -> None:
    """End-to-end indexing through ``index_folder`` (decode, host prepare,
    device preprocess and encode, store) of 1,536 synthetic 480x640 JPEGs
    at ViT-B/32 after a warm folder, split by stage, beside the decode-only
    rate and a host-to-device copy probe of one batch's canvases before and
    after; checks the count, the decode route (the native planar decode
    where its decoders are built) and the canvas bytes copied."""
    from .engine import SearchEngine
    from .preprocess import prepare_batch, prepare_batch_planar
    from .preprocess.io import has_native_decode, load_batch_planar

    tmp = Path(tempfile.mkdtemp(prefix="bench_index_"))
    eng = None
    try:
        rng = np.random.default_rng(0)
        base = rng.integers(0, 256, (*PHOTO, 3), dtype=np.uint8)
        t0 = time.perf_counter()
        jpegs = _write_photos(tmp, INDEX_IMAGES, base, vary=True)
        log(f"index: wrote {INDEX_IMAGES} JPEGs in {time.perf_counter() - t0:.2f} s")
        cfg = Config(env_path=None)
        eng = SearchEngine(cfg=cfg, spec=CLIP_MODEL_SPECS[MODEL], device=run.device)
        eng.warmup()
        warm = tmp / "warm"
        warm.mkdir()
        _write_photos(warm, eng._index_batch, base, vary=False)
        eng.index_folder(str(warm))  # first-call costs, same image shape
        shutil.rmtree(warm)
        run.step("engine warm")

        short = cfg.DECODE_SHORT_SIDE or eng.spec.image_size
        ents = load_batch_planar(jpegs[: eng._index_batch], min_short_side=short, fast=True)
        planes = [e for e in ents if isinstance(e, tuple)]
        if planes:
            yc, cc, *_ = prepare_batch_planar(planes, target=eng.spec.image_size)
            canvases = [yc, cc]
        else:
            canvases = [prepare_batch([e for e in ents if e is not None],
                                      target=eng.spec.image_size)[0]]
        pre = _copy_probe(run, canvases) if run.cuda else {}

        base_t = eng.timers.snapshot()
        base_c = eng.counters.snapshot()
        t0 = time.perf_counter()
        count = eng.index_folder(str(tmp))
        wall = time.perf_counter() - t0
        post = _copy_probe(run, canvases) if run.cuda else {}
        snap_t, snap_c = eng.timers.snapshot(), eng.counters.snapshot()
        run.step("indexed")
        shipped = snap_c.get("upload_canvas_bytes", 0) - base_c.get("upload_canvas_bytes", 0)
        routes = {k: v - base_c.get(k, 0) for k, v in snap_c.items()
                  if k.startswith("decode_") and v - base_c.get(k, 0)}
        split = {name: round(snap_t[name]["total_s"]
                             - base_t.get(name, {}).get("total_s", 0.0), 4)
                 for name in ("index_decode", "index_prepare", "prep_encode",
                              "prep_encode_fetch") if name in snap_t}
        want = "decode_native_planar" if has_native_decode() else "decode_pillow"
        run.check("index_count", count == INDEX_IMAGES, f"{count} of {INDEX_IMAGES}")
        run.check("index_decode_route", routes == {want: INDEX_IMAGES},
                  f"{routes} (want {want} for all)")
        run.check("index_canvas_bytes", shipped > 0, f"{shipped:.0f} bytes copied")

        t0 = time.perf_counter()
        n_ok = 0
        for start in range(0, len(jpegs), eng._index_batch):
            n_ok += sum(e is not None for e in load_batch_planar(
                jpegs[start : start + eng._index_batch], min_short_side=short, fast=True))
        dec_ips = n_ok / (time.perf_counter() - t0)
        e2e = count / wall
        run.summary(f"index end to end: {count} images in {wall:.3f} s (n=1) = {e2e:.1f} "
                    f"images/s ({os.cpu_count()} host cores; {e2e / dec_ips:.1%} of "
                    f"the decode-only {dec_ips:.1f} images/s, n=1); stages {split} s; "
                    f"decode routes {routes}; canvases copied {shipped / 1e6:.1f} MB "
                    f"(>= {shipped / wall / 1e6:.1f} MB/s); copy probe before {pre}, "
                    f"after {post} {card_words(run)}")
    finally:
        if eng is not None:
            eng.close()
        shutil.rmtree(tmp, ignore_errors=True)


def bench_device_pipeline(run: Run) -> None:
    """The indexing device ceiling: the engine's fused resample, crop,
    normalize and ViT-B/32 encode (``_prep_encode``) of 128 random
    480x640 canvases already on the card, CUDA events over 12 launches."""
    from .engine import SearchEngine
    from .preprocess import prepare_batch

    rng = np.random.default_rng(0)
    arrays = [rng.integers(0, 256, (*PHOTO, 3), dtype=np.uint8)
              for _ in range(PIPELINE_BATCH)]
    eng = SearchEngine(cfg=Config(env_path=None), spec=CLIP_MODEL_SPECS[MODEL],
                       device=run.device)
    try:
        canvases, a_h, a_w, size_idx = prepare_batch(arrays, target=eng.spec.image_size)
        t0 = time.perf_counter()
        args = [torch.from_numpy(a).to(run.device) for a in (canvases, a_h, a_w, size_idx)]
        run.sync()
        log(f"device_pipeline: copied {canvases.nbytes / 1e6:.1f} MB of canvases in "
            f"{time.perf_counter() - t0:.3f} s (once)")
        params = eng.params
        out = eng._prep_encode(params, *args)
        run.check("device_pipeline_finite", bool(torch.isfinite(out).all()),
                  f"embeddings {tuple(out.shape)}")
        ms = device_ms(run, lambda: eng._prep_encode(params, *args), PIPELINE_REPS)
        run.summary(f"device pipeline ({PHOTO[0]}x{PHOTO[1]} uint8 -> embedding, "
                    f"batch {PIPELINE_BATCH}): {timing(ms)} -> "
                    f"{PIPELINE_BATCH / median(ms) * 1e3:.1f} images/s {card_words(run)}")
    finally:
        eng.close()


def _write_store(folder: Path, rows: int, chunk: int, dtype_name: str, rng,
                 path: str, cfg: Config) -> np.ndarray:
    """A store of ``rows`` unit Gaussian rows written through IndexWriter,
    every row pointing at ``path``; returns the last chunk."""
    from .index.store import IndexWriter

    w = IndexWriter.create(folder, model=MODEL, dim=DIM, dtype_name=dtype_name,
                           index_folder_name=cfg.INDEX_FOLDER_NAME)
    emb = None
    for start in range(0, rows, chunk):
        m = min(chunk, rows - start)
        emb = rng.standard_normal((m, DIM)).astype(np.float32)
        emb /= np.linalg.norm(emb, axis=1, keepdims=True)
        w.append(emb, [path] * m, [{}] * m)
    w.finalize()
    return emb


def bench_hbm(run: Run) -> None:
    """Device-budget eviction and the SQ8 certificate's fallback on the
    card. One engine under a 480 MB budget and two 300,000-row bf16
    folders: caching B evicts A, querying A again evicts B (2 evictions).
    A second engine under 4 MB and a 7,000-row f32 folder whose even rows
    are one row: the int8 sidecar fits, the corpus does not, so the folder
    takes the SQ8 tier, whose certificate fails on the 3,500-row tie
    plateau, and the host fallback must return rows 0, 2, 4, ..."""
    from .engine import SearchEngine
    from .index.store import IndexWriter

    tmp = Path(tempfile.mkdtemp(prefix="bench_hbm_"))
    eng = eng2 = None
    try:
        rng = np.random.default_rng(0)
        cfg = Config(env_path=None)
        cfg.HBM_BUDGET_MB = HBM_BUDGETS_MB[0]
        queries = {}
        for name in ("a", "b"):
            last = _write_store(tmp / name, HBM_ROWS, HBM_CHUNK, "bfloat16", rng,
                                str(tmp / name / "x.jpg"), cfg)
            q = (last[0] + 0.01).astype(np.float32)
            queries[name] = q / np.linalg.norm(q)
        eng = SearchEngine(cfg=cfg, spec=CLIP_MODEL_SPECS[MODEL], device=run.device)
        run.step("stores written")

        def q(name: str) -> float:
            t0 = time.perf_counter()
            _, i, _ = eng.search_embedding(str(tmp / name), queries[name], K)
            if len(i) != K:
                raise RuntimeError(f"hbm: {len(i)} results, not {K}")
            return (time.perf_counter() - t0) * 1e3

        q("a")
        a_warm = [q("a") for _ in range(3)]
        ev0 = eng.counters.snapshot().get("hbm_evictions", 0)
        b_first = q("b")
        a_remat = q("a")
        evictions = int(eng.counters.snapshot().get("hbm_evictions", 0) - ev0)
        a_steady = [q("a") for _ in range(3)]
        reserved = eng.hbm_snapshot()["reserved_bytes"]
        run.check("hbm_evictions", evictions == 2, f"{evictions} evictions (2)")
        run.step("eviction measured")

        folder_c = tmp / "c"
        emb_c = rng.standard_normal((TIE_ROWS, DIM)).astype(np.float32)
        emb_c /= np.linalg.norm(emb_c, axis=1, keepdims=True)
        emb_c[::2] = emb_c[0]
        w = IndexWriter.create(folder_c, model=MODEL, dim=DIM, dtype_name="float32",
                               index_folder_name=cfg.INDEX_FOLDER_NAME)
        w.append(emb_c, [str(folder_c / "x.jpg")] * TIE_ROWS, [{}] * TIE_ROWS)
        w.finalize()
        cfg2 = Config(env_path=None)
        cfg2.HBM_BUDGET_MB = HBM_BUDGETS_MB[1]
        eng2 = SearchEngine(cfg=cfg2, spec=CLIP_MODEL_SPECS[MODEL], device=run.device)
        qc = emb_c[0] + TIE_NOISE * rng.standard_normal(DIM).astype(np.float32)
        qc = (qc / np.linalg.norm(qc)).astype(np.float32)
        _, i, _ = eng2.search_embedding(str(folder_c), qc, K)
        snap2 = eng2.counters.snapshot()
        tie_exact = bool(np.array_equal(np.asarray(i), np.arange(0, 2 * K, 2)))
        fallbacks = int(snap2.get("sq8_fallback_queries", 0))
        sq8_queries = int(snap2.get("sq8_queries", 0))
        run.check("hbm_sq8_tie_exact", tie_exact, f"rows {np.asarray(i)[:6].tolist()}...")
        run.check("hbm_sq8_fallback", fallbacks == 1 and sq8_queries == 1,
                  f"{fallbacks} fallbacks of {sq8_queries} SQ8 queries (1 of 1)")
        mb = HBM_ROWS * DIM * 2 / 2**20
        run.summary(f"device budget: 2 x {mb:.1f} MiB bf16 folders under "
                    f"{HBM_BUDGETS_MB[0]} MiB: {evictions} evictions (A steady "
                    f"{timing(a_warm)} -> B first {b_first:.3f} ms (n=1) -> A again "
                    f"{a_remat:.3f} ms (n=1) -> A steady {timing(a_steady)}; "
                    f"{reserved / 2**20:.1f} MiB reserved); SQ8 certificate fallback "
                    f"{fallbacks}/{sq8_queries} queries, tie-exact={tie_exact} "
                    f"{card_words(run)}")
    finally:
        for e in (eng, eng2):
            if e is not None:
                e.close()
        shutil.rmtree(tmp, ignore_errors=True)


def bench_serve(run: Run) -> None:
    """The HTTP app in-process (``create_app``, ``TestClient``) over one
    1,000,000-row bf16 store whose rows all point at one real JPEG: a warm
    request, a concurrent warm wave, then 8 threads x 40 fresh-text
    ``/search`` requests (each a text-cache miss: tokenizer, text tower,
    batched search, thumbnail); every request must return 200."""
    from PIL import Image

    from .engine import SearchEngine
    from .server import TestClient, create_app

    tmp = Path(tempfile.mkdtemp(prefix="bench_serve_"))
    eng = None
    try:
        rng = np.random.default_rng(0)
        img_path = tmp / "row.jpg"
        Image.fromarray(rng.integers(0, 256, (*PHOTO, 3), dtype=np.uint8)).save(
            img_path, quality=85)
        cfg = Config(env_path=None)
        t0 = time.perf_counter()
        _write_store(tmp, SERVE_ROWS, SERVE_CHUNK, "bfloat16", rng, str(img_path), cfg)
        log(f"serve: wrote {SERVE_ROWS} bf16 rows in {time.perf_counter() - t0:.2f} s")
        eng = SearchEngine(cfg=cfg, spec=CLIP_MODEL_SPECS[MODEL], device=run.device)
        eng.warmup()
        app = create_app(engine=eng, cfg=cfg)

        def query(client, tag):
            return client.post("/search", json_body={
                "folder": str(tmp), "query": f"benchmark query {tag}", "limit": 12})

        t0 = time.perf_counter()
        r = query(TestClient(app), "warm")
        run.check("serve_warm_request", r.status_code == 200, f"{r.status_code}")
        log(f"serve: first request (corpus copy and first calls) "
            f"{time.perf_counter() - t0:.3f} s")
        query(TestClient(app), "warm2")
        run.step("warm")

        def run_threads(target, count):
            threads = [threading.Thread(target=target, args=(t,), daemon=True)
                       for t in range(count)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=max(run.deadline - time.perf_counter(), 1.0))
            if any(t.is_alive() for t in threads):
                raise PhaseOverBudget("serve: client threads still running at the budget")

        # every query-row bucket the concurrent burst can form, before timing
        run_threads(lambda t: query(TestClient(app), f"wave-{t}"), SERVE_THREADS)
        run.step("concurrent warm wave")
        lat: list[float] = []
        statuses: list[int] = []
        lock = threading.Lock()

        def worker(tid):
            client = TestClient(app)
            mine, codes = [], []
            for i in range(SERVE_PER_THREAD):
                t0 = time.perf_counter()
                r = query(client, f"{tid}-{i}")
                codes.append(r.status_code)
                if r.status_code == 200:
                    mine.append((time.perf_counter() - t0) * 1e3)
            with lock:
                lat.extend(mine)
                statuses.extend(codes)

        t0 = time.perf_counter()
        run_threads(worker, SERVE_THREADS)
        wall = time.perf_counter() - t0
        total = SERVE_THREADS * SERVE_PER_THREAD
        ok = sum(code == 200 for code in statuses)
        run.check("serve_all_200", ok == total, f"{ok}/{total} returned 200")
        fb = eng.__dict__.get("_fused_batcher_inst")
        batching = ""
        if fb is not None:
            batching = (f"; fused text->search {fb.batched_queries} queries in "
                        f"{fb.dispatches} dispatches")
        run.summary(f"serve HTTP {SERVE_THREADS} threads x {SERVE_PER_THREAD} fresh-text "
                    f"/search over {SERVE_ROWS} bf16 rows: {ok / wall:.2f} requests/s, "
                    f"{timing(lat) if lat else 'no latency'}{batching} {card_words(run)}")
    finally:
        if eng is not None:
            eng.close()
        shutil.rmtree(tmp, ignore_errors=True)


def bench_train(run: Run) -> None:
    """The contrastive train step (forward, backward, clipped AdamW) of
    ViT-B/32 in bf16 with remat at 256 pairs of synthetic preprocessed
    images and token rows, CUDA events over 10 steps after 3."""
    from .models import init_params
    from .train import make_optimizer, make_train_step

    spec = CLIP_MODEL_SPECS[MODEL]
    model = init_params(spec, seed=0, device=run.device)
    optimizer = make_optimizer()
    state = optimizer.init(model)
    step = make_train_step(spec, optimizer, compute_dtype=torch.bfloat16)
    gen = run.generator(1)
    images = torch.randn(TRAIN_BATCH, spec.image_size, spec.image_size, 3, generator=gen,
                         device=run.device).to(torch.bfloat16)
    tokens = torch.randint(0, spec.vocab_size, (TRAIN_BATCH, spec.context_length),
                           generator=run.generator(2), device=run.device)
    losses: list = []
    ms = device_ms(run, lambda: losses.append(step(model, state, images, tokens)),
                   TRAIN_REPS)
    loss = torch.stack(losses).float().cpu()
    run.check("train_loss_finite", bool(torch.isfinite(loss).all()),
              f"losses {loss[0].item():.4f} .. {loss[-1].item():.4f}")
    flops = 3 * (_vit_fwd_flops(spec) + _text_fwd_flops(spec)) * TRAIN_BATCH
    run.summary(f"train {spec.name} bf16 step (forward, backward, AdamW; remat; batch "
                f"{TRAIN_BATCH}): {timing(ms)} -> {TRAIN_BATCH / median(ms) * 1e3:.1f} "
                f"pairs/s, {mfu_words(run, flops / (median(ms) * 1e-3))} (3x the "
                f"forward's products; remat's recompute not counted)")


def _bench_encode(run: Run, phase: str) -> torch.Tensor:
    """Image-tower throughput of ENCODE[phase]'s model in bf16 from seeded
    random weights: CUDA events over its launches; images/s and MFU
    against the analytic products. Returns the model."""
    from .models import encode_image, init_params

    name, batch, reps = ENCODE[phase]
    spec = CLIP_MODEL_SPECS[name]
    model = init_params(spec, seed=0, device=run.device).eval()
    images = torch.randn(batch, spec.image_size, spec.image_size, 3,
                         generator=run.generator(5), device=run.device).to(torch.bfloat16)
    out = encode_image(model, images, torch.bfloat16)
    run.check(f"{phase}_finite", bool(torch.isfinite(out).all()),
              f"embeddings {tuple(out.shape)}")
    ms = device_ms(run, lambda: encode_image(model, images, torch.bfloat16), reps)
    ips = batch / median(ms) * 1e3
    run.summary(f"encode {name} bf16 (batch {batch}): {timing(ms)} -> {ips:.1f} images/s, "
                f"{mfu_words(run, ips * image_fwd_flops(spec))}")
    return model


def bench_encode(run: Run) -> None:
    """ViT-B/32 image-tower throughput at batch 512."""
    _bench_encode(run, "encode")


def bench_encode_b16(run: Run) -> None:
    """ViT-B/16 image-tower throughput at batch 128."""
    _bench_encode(run, "encode_b16")


def bench_encode_l14(run: Run) -> None:
    """ViT-L/14 image-tower throughput at batch 64; then, on four images,
    the card's f32 tower against the CPU's f32 (cosine >= 0.99999 each)
    and bf16's cosine to f32 beside it."""
    from .models import encode_image

    model = _bench_encode(run, "encode_l14")
    spec = model.spec
    x = torch.randn(L14_CHECK_IMAGES, spec.image_size, spec.image_size, 3,
                    generator=torch.Generator().manual_seed(6))
    f32 = encode_image(model, x.to(run.device), torch.float32).double().cpu()
    bf16 = encode_image(model, x.to(run.device), torch.bfloat16).double().cpu()
    run.step("card towers")
    cpu = encode_image(model.cpu(), x, torch.float32).double()
    cos = (f32 * cpu).sum(1) / (f32.norm(dim=1) * cpu.norm(dim=1))
    cos_bf16 = (bf16 * f32).sum(1) / (bf16.norm(dim=1) * f32.norm(dim=1))
    run.check("encode_l14_card_vs_cpu", bool((cos >= 0.99999).all()),
              f"f32 cosine min {cos.min().item():.8f} (>= 0.99999)")
    run.summary(f"encode {spec.name} on {L14_CHECK_IMAGES} images: card f32 against "
                f"CPU f32 cosine min {cos.min().item():.8f}; bf16 against f32 cosine "
                f"min {cos_bf16.min().item():.6f} {card_words(run)}")


def bench_encode_rn50(run: Run) -> None:
    """RN50 image-tower throughput at batch 128."""
    _bench_encode(run, "encode_rn50")


# bench.py's main() order
PHASES = {
    "search": bench_search, "sq8": bench_sq8, "ivf": bench_ivf, "index": bench_index,
    "hbm": bench_hbm, "serve": bench_serve, "train": bench_train,
    "encode": bench_encode, "encode_b16": bench_encode_b16,
    "encode_l14": bench_encode_l14, "encode_rn50": bench_encode_rn50,
    "device_pipeline": bench_device_pipeline, "ivf_10m": bench_ivf_10m,
    "search_10m": bench_search_10m,
}


def select_phases(spec: str | None) -> list[str]:
    """``name,name,...`` -> those phases in ``PHASES``' order (all when
    None); an unknown name raises ValueError."""
    if spec is None:
        return list(PHASES)
    names = {s.strip() for s in spec.split(",") if s.strip()}
    unknown = names - set(PHASES)
    if unknown:
        raise ValueError(f"unknown phases {sorted(unknown)}; known: {', '.join(PHASES)}")
    return [name for name in PHASES if name in names]


def _zero_launches() -> None:
    for counts in (topk.LAUNCHES, topk.DTYPE_LAUNCHES):
        for key in counts:
            counts[key] = 0


def run_phase(run: Run, name: str):
    """One phase under its budget, its launches counted from 0, its memory
    read before and after, everything it held freed after. Returns what
    the phase returned, or None where it failed."""
    budget = BUDGETS_S.get(name, DEFAULT_BUDGET_S)
    held = torch.cuda.memory_allocated(run.device) if run.cuda else None
    if run.cuda:
        torch.cuda.reset_peak_memory_stats(run.device)
    log(f"[{name}] start: {held} bytes held on the card" if run.cuda
        else f"[{name}] start")
    _zero_launches()
    run.phase = name
    t0 = time.perf_counter()
    run.deadline = t0 + budget
    result, ok = None, True
    try:
        with capture_trace():
            result = PHASES[name](run)
        run.sync()
    except Exception:  # a phase's failure must not stop the later phases
        log(f"[{name}] FAILED:\n{traceback.format_exc()}")
        ok = False
    seconds = time.perf_counter() - t0
    if seconds > budget:
        log(f"[{name}] FAILED: {seconds:.1f} s over its {budget} s budget")
        ok = False
    if not ok:
        run.failures.append(f"phase {name}")
    run.deadline = math.inf
    line = {"name": name, "ok": ok, "seconds": seconds, "budget_s": budget,
            "held_bytes": held,
            "peak_bytes": torch.cuda.max_memory_allocated(run.device) if run.cuda else None,
            "launches": dict(topk.DTYPE_LAUNCHES)}
    log("phase " + json.dumps(line))
    gc.collect()
    if run.cuda:
        torch.cuda.empty_cache()
        # cuBLAS keeps a 32 MiB workspace for each thread that ran a
        # product, for the life of the process: dropped here, the next
        # phase's held bytes are what a phase left behind
        torch._C._cuda_clearCublasWorkspaces()
    return result


def run_bench(names: list[str], device) -> int:
    """The selected phases in order on ``device``; the headline line on
    stdout right after ``search``. Returns the exit code."""
    run = Run(device)
    t0 = time.perf_counter()
    for name in names:
        result = run_phase(run, name)
        if name == "search" and result is not None:
            print(json.dumps({"metric": METRIC, "value": result["per_query_ms"],
                              "unit": "ms", "device": run.card}), flush=True)
        del result
    log(f"==== summary ({len(names)} phases in {time.perf_counter() - t0:.1f} s) ====")
    for line in run.lines:
        log("| " + line)
    log(f"failures: {run.failures or 'none'}")
    return 1 if run.failures else 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m evossearch_tpu_torch.bench",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("--phases", help="comma-separated phases, run in "
                        f"this order: {','.join(PHASES)} (default: all)")
    args = parser.parse_args(argv)
    try:
        names = select_phases(args.phases)
    except ValueError as e:
        parser.error(str(e))
    if not torch.cuda.is_available():
        raise RuntimeError("bench: no CUDA device; the bench measures the card "
                           "and has no CPU run")
    from .ops import _build

    t0 = time.perf_counter()
    _build.build()  # every kernel library, one nvcc each, started together
    log(f"kernels built or found in {time.perf_counter() - t0:.1f} s")
    return run_bench(names, "cuda")


if __name__ == "__main__":
    sys.exit(main())
