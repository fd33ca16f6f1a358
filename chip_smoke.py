"""Smoke run of evossearch_tpu_torch on one CUDA GPU.

    python3 chip_smoke.py

Builds the top-k kernels from evossearch_tpu_torch/ops/csrc with nvcc
(one nvcc per source, in parallel) and, beside them, the package's host
extension with g++ (phase ``native``: the threaded host scanner, and the
libjpeg decoders, by the system's libjpeg or the one Pillow bundles,
which must decode a JPEG there), holds each
kernel against its plain PyTorch
version and a dense oracle (a stable sort written here), times them (and
checks and times the dense path's selection, stable_topk, against that
sort and torch.topk), then drives six paths, each with the launch
counts set to 0 just before it and read just after (and last checks the
block and tree kernels at 67,110,913 rows of d = 128, f32 and bf16, past
the 67,106,816 rows the block kernel's grid once capped it at):

  * the SQ8 time split (``evossearch_tpu_torch.scripts.exp_sq8_perf``):
    B1, B3 and B3's two E1 variants (``sq8_variant``) over 1,048,576 and
    10,485,760 seeded unit rows, and the tier's device half;
  * f32 corpora of 262,144 and 1,048,576 seeded unit rows on the card
    through the search routing (``index.search.best_exact_search_batch``),
    so B2 and B1 run on their f32 paths;

and, at full ViT-B/32 width (seeded random weights, bf16 compute and
store), as users start the port:

  * ``checkpoint_convert``: a ViT-B/32 checkpoint in the OpenAI release
    layout (fp16, from the seed) goes through ``python -m
    evossearch_tpu_torch convert`` to the native npz; engines on the two
    files give bit-equal embeddings, and the app then starts from the
    ``.pt`` with the default decode flags;
  * ``planar_device``: the planar 4:2:0 device preprocess of 128 mixed
    images on the card against the CPU, and the planar encode against the
    RGB one;
  * the main path: the HTTP app indexes 64 JPEGs twice (Pillow and RGB
    canvases, then the defaults: the native planar decode where it is
    built, its embeddings held against Pillow/RGB's by cosine), each
    /index split into decode, host prepare and encode, and
    answers /search and /search_by_image, and text searches over two
    seeded stores of 262,144 and 1,048,576 rows reach the block and the
    tree kernel through the engine's normal routing; ``host_scan`` then
    times the native host scanner against numpy over the 1,048,576-row
    store, and ``cli`` runs the CLI's ``index`` and ``search`` in
    subprocesses, which must print the engine's rows;
  * the library entry point ``evossearch_tpu_torch.ops.fused_topk`` (the
    single-query stream kernel) over the 1,048,576-row store, bf16 as the
    engine holds it and an f32 copy;
  * the over-budget folder: a 2,097,152-row store (2 GiB of bf16) under a
    device budget lowered to 1536 MiB through EVOSSEARCH_HBM_BUDGET_MB
    (a store over the card's own 80% budget would need over 64 GB of
    disk), so the engine's routing sends its text and embedding searches
    to the SQ8 tier and the int8 bound-sweep kernel; one search is then
    split into its stages (device half, copy back, row gather, rerank and
    certificate);
  * ``train``: contrastive training at ViT-B/32 full width from the
    converted npz, through the CLI's ``train`` in subprocesses on a
    seeded caption folder (2 epochs, then 1 resumed: the loss falls, the
    epochs continue), the trained checkpoint in an engine, retrieval
    accuracy before and after, the card's f32 and bf16 loss and
    gradients against the CPU's, remat on against off, and step times and
    peak memory at batch 32 and 256 (launches counted: none of the
    kernels is on this path), after the paths above are freed;
  * ``train_mesh``: the mesh half of training on the same folder and npz,
    f32 with remat: one step at batch 32 on the (data, model) meshes
    (4, 1), (2, 2) and (1, 4) over [cuda:0] * 4 against the one-device
    step (loss, every gradient leaf by cosine, the largest parameter
    difference and its leaf, step ms, peak memory), bf16 on (2, 2) by
    cosine, ``fit`` on (2, 2) for an epoch resumed for one on one device,
    ``save_sharded`` of the (2, 2) params and Adam state restored onto
    (2, 2) and (4, 1) bit for bit, and ``index.search.exact_search`` of
    single queries over the 1,048,576-row store (the tree kernel),
    equal to the batch route's rows;

then, before the last check, the slices that serve other settings:

  * ``ivf``: EVOSSEARCH_INDEX_KIND=ivf over a clustered bf16 store of
    1,048,576 rows (1,024 random unit centres, Gaussian noise of sigma
    1.2/sqrt(d)): the build through an engine, split into k-means,
    assignment, layout and calibration; recall@48 of the calibrated
    nprobe against the exact path on 64 noisy queries; the full probe
    against exact; IVF against exact (``best``) at Q = 1 and 48, CUDA
    events; the sidecar's save and a second engine's reload without
    retraining; a third engine under a budget below 3x the corpus that
    probes the sidecar on the host, beside the native exact host scan;
  * ``sharded``: the search half of corpus sharding (``parallel/``) on
    one card, over the stores the phases above wrote: ``ShardedIndex`` on
    [cuda:0] * S (the 1,048,576-row store at S = 4 and a ragged S = 3,
    B2 in each block; the over-budget folder's 2,097,152 rows at S = 2,
    B1) at Q = 48, 1 and 129 against the single-device route, with the
    host merge's ms; ``SQ8ShardedIndex`` at S = 4 on the over-budget
    sidecar (B3 per block) against the one-device tier; a
    ``ShardedIVFIndex`` built at S = 4 over the clustered store (full
    probe against exact, recall@48 of the calibrated nprobe, save and
    reload, a mesh of the wrong size); the engine and /search under
    EVOSSEARCH_SEARCH_KERNEL=sharded against ``best`` (the over-budget
    folder through SQ8ShardedIndex, INDEX_KIND=ivf with ivf_mesh1.npz);
    data-parallel encode of the 64 photos over [cuda:0, cuda:0] against
    one device;
  * ``resnet``: RN50 at its published full width from a seeded
    OpenAI-layout fp16 ``.pt`` through load_checkpoint into the app: the
    image tower's time per 128-image batch, the card's f32 (cuDNN's TF32
    off inside the forward) and bf16 embeddings against the CPU's f32,
    and, counted like the paths above, /index, /search and
    /search_by_image on 64 photos and the block, tree and SQ8 kernels at
    the tower's d = 1024 through the engine;
  * ``kernel_check_d1024``: B1 and B2 bit for bit against their plain
    versions at d = 1024 (262,144 and 1,048,576 rows, Q and every query
    bucket), B3 at 1,000,003 and 262,144 rows, Q and every query bucket,
    and the tensor cores' accumulation error;
  * ``bench``: the port's bench as users start it, ``python -m
    evossearch_tpu_torch.bench --phases search,encode_l14`` in a
    subprocess: the headline (exact top-48 of 48 queries over 1,000,000
    unit f32 rows, the tree kernel's f32 path) held against the bench's
    own float64 oracle, and ViT-L/14's image tower at batch 64 with its
    card-against-CPU check; exit code, the stdout line, the checks and the
    bench's launch counts;
  * ``scripts``: the JAX package's four profilers as the port's scripts,
    each as users start it (``python -m
    evossearch_tpu_torch.scripts.<name>``) in a subprocess:
    ``exp_merge_variants`` (B1's merge in cumulative stages, with
    production and two alternates, at 1,000,000 bf16 and f32 rows and
    10,000,000 bf16 rows), ``exp_merge_profile`` (torch.profiler over the
    packed tree search: tracks, top device kernels, the card's idle
    share; it must name B1's kernel), ``exp_rn50_profile`` (RN50's
    segments and batch sweep) and ``exp_index_producer`` (host only: the
    build with a stub encoder against decode-only); exit codes, their
    checks, their key lines and their launch counts;
  * ``reference_suites``: the JAX package's engine suites as the port
    holds them (``tests/test_torch_ref_*.py``: the HTTP contract, the
    device budget, the batchers, the search kernels' selection, the
    round-4 and round-5 fixes), their ``gpu`` cases in a subprocess,
    ``python -m pytest --noconftest -q -p no:cacheprovider -m gpu``:
    every case must pass and none skip, each file must run at least one,
    and the engine's case through the block kernel must be among them.

Every line on stdout but the last is one result: a JSON object, or the
card's name and power limit as nvidia-smi reports them. In the closing
``kernels`` line, ``sq8_variant`` reports the bf16_struct variant (both
variants have a ``kernel_check`` line), and ``tree_f32``, ``block_f32``
and ``stream_f32`` the kernels' f32 paths; ``launches`` and
``launches_rn50`` count each kernel's launches by corpus dtype
(``ops.topk.DTYPE_LAUNCHES``) on the main path and on the resnet phase's
path, ``launches_sharded`` on the sharded phase's, ``launches_train``
on the train phase's, ``launches_train_mesh`` on the train_mesh
phase's, ``launches_bench`` on the bench's phases and
``launches_scripts`` those the experiment scripts report. The last line is
{"ok": true, "device": {...}}. Any failed check raises and the script
exits non-zero with no last line. Without a GPU it exits 1 at once.
"""

from __future__ import annotations

import gc
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
TREE_BF16_TILES = (8192,)  # bf16 tile rows checked besides production's 16384
N_SQ8 = 1 << 21     # the over-budget folder, and the SQ8 kernel checks
N_SQ8_TAIL = 1_000_003  # a partial last SQ8 tile, n % 4 != 0 (radd unaligned)
N_STREAM = 1 << 20  # the stream kernel checks
SQ8_BUDGET_MB = 1536  # corpus 2 GiB over it, sidecar 1.02 GiB within it
SQ8_FETCH = 512       # the tier's default fetch (EVOSSEARCH_SQ8_FETCH)
SEED = 0              # the seed of the ivf and resnet phases' data and weights
N_IVF = 1 << 20       # the ivf phase's clustered store
IVF_CENTRES = 1024    # its cluster centres
IVF_QUERIES = 64      # its noisy queries (recall@48)
IVF_BUDGET_MB = 2048  # the corpus (1 GiB) within it, the IVF (3x) over it
RN50_STORE = 1 << 18  # the resnet phase's d = 1024 store: block at k=48, tree at k=12
RN50_SQ8_BUDGET_MB = 384  # that store (512 MiB) over it, its sidecar (258 MiB) within
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


def exact_inputs(n: int, dtype, gen: torch.Generator, d: int = D):
    """Rows and 128 queries of small integers over 16: every dot is exact
    in float32 in any summation order, and equal scores tie for real."""
    emb = torch.randint(-4, 5, (n, d), generator=gen, device="cuda") / 16.0
    q = torch.randint(-4, 5, (max(QUERY_BUCKETS), d), generator=gen,
                      device="cuda") / 16.0
    return emb.to(dtype).contiguous(), q.float()


def unit_rows(n: int, gen: torch.Generator, device="cuda", d: int = D) -> torch.Tensor:
    x = torch.randn(n, d, generator=gen, device=device)
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
            if name == "tree" and dtype == torch.bfloat16 and k == 48:
                extra.update(tree_tile_bit_equality(topk, emb, q_all, bit_equal_q))
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


def tree_tile_bit_equality(topk, emb: torch.Tensor, q_all: torch.Tensor,
                           bit_equal_q) -> dict:
    """The tree kernel over the bf16 exact-dot rows at the tile rows that
    exp_merge_variants' tile sweep (a3) launches besides production's,
    bit for bit against its plain version at Q and every query bucket."""
    for tile in TREE_BF16_TILES:
        for nq in bit_equal_q:
            got = topk.tree_candidates(emb, q_all[:nq], tile)
            torch.cuda.synchronize()
            want = topk.tree_candidates_plain(emb, q_all[:nq], tile)
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"tree bf16 candidates at tile {tile} Q={nq} equal the plain "
                  "version bit for bit")
            del got, want
    return {"bit_equal_plain_at_tiles": [topk._tree_tile_rows(torch.bfloat16),
                                         *TREE_BF16_TILES]}


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


def exact_sq8_inputs(n: int, gen: torch.Generator, d: int = D):
    """int8 rows, power-of-two scales, queries of small integers over 16:
    every bound's dot is exact in float32, and equal bounds tie for real."""
    e8 = torch.randint(-127, 128, (n, d), generator=gen, device="cuda",
                       dtype=torch.int8)
    scale = 2.0 ** -torch.randint(5, 10, (n,), generator=gen, device="cuda").float()
    radd = torch.rand(n, generator=gen, device="cuda") * 1e-2
    q = torch.randint(-4, 5, (max(QUERY_BUCKETS), d), generator=gen,
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


def accumulation_check(topk, gen: torch.Generator, d: int = D) -> dict:
    """The tensor cores' accumulation against the model the SQ8 certificate
    relies on (ops/csrc/topk_tc.cuh): int8_noscale's emitted raw dots
    (cand_s at cand_i) over cancellation-heavy rows (int8 values of
    alternating sign by column, a one-signed bf16 query whose values span
    2^14, so partial sums need more than 24 bits) against float64 dots of
    the same rows. The worst error, in units of d*2^-24*sum|e8*q~|, must be
    at most 2 (a truncating accumulation's bound)."""
    n, tile = N_SQ8_TAIL, topk.SQ8_TILE_ROWS
    sign = (1 - 2 * (torch.arange(d, device="cuda") % 2)).to(torch.int16)
    e8 = (torch.randint(64, 128, (n, d), generator=gen, device="cuda",
                        dtype=torch.int16) * sign).to(torch.int8)
    mag = torch.rand(Q, d, generator=gen, device="cuda") + 0.5
    q = mag * 2.0 ** -torch.randint(0, 14, (Q, d), generator=gen, device="cuda").float()
    q = (q / torch.linalg.norm(q, dim=1, keepdim=True)).bfloat16().float()
    cand_s, cand_i, _ = topk.sq8_variant_candidates(e8, None, q, None, "int8_noscale", tile)
    worst = 0.0
    qd = q.double()
    for j in range(Q):
        live = cand_i[j] < n  # the partial last tile's padding rows
        rows = e8[cand_i[j][live].long()].double()
        p = rows * qd[j]
        err = (cand_s[j][live].double() - p.sum(1)).abs()
        worst = max(worst, float((err / (d * 2.0 ** -24 * p.abs().sum(1))).max()))
    check(worst <= 2, f"tensor-core accumulation error within 2*d*2^-24*sum|p| at "
          f"d = {d} ({worst})")
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


def zero_launches(topk) -> None:
    """Set every launch count (by kernel, and by kernel and corpus dtype)
    to 0."""
    for counts in (topk.LAUNCHES, topk.DTYPE_LAUNCHES):
        for name in counts:
            counts[name] = 0


def sq8_split_path(topk) -> int:
    """The SQ8 time split (scripts/exp_sq8_perf.run) with the launch counts
    set to 0 just before and read just after; returns the E1 variants'
    launches on this path."""
    from evossearch_tpu_torch.scripts import exp_sq8_perf

    zero_launches(topk)
    rows = exp_sq8_perf.run()
    launches = dict(topk.DTYPE_LAUNCHES)
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
    zero_launches(topk)
    out = {n: search.best_exact_search_batch(emb, queries, k) for n, emb in corpora.items()}
    torch.cuda.synchronize()
    launches = dict(topk.DTYPE_LAUNCHES)
    check(launches["block_f32"] > 0 and launches["tree_f32"] > 0,
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


def write_store(folder: Path, n: int, gen: torch.Generator, d: int = D,
                model: str = "ViT-B/32", rows=None) -> None:
    """A bf16 store of ``n`` seeded rows of width ``d``: ``rows(m)`` makes
    each chunk on the card (default: unit rows), which rounds it to bf16
    there and hands the writer its bit patterns."""
    from evossearch_tpu_torch.index import IndexWriter

    rows = rows or (lambda m: unit_rows(m, gen, d=d))
    folder.mkdir(parents=True, exist_ok=True)
    w = IndexWriter.create(folder, model=model, dim=d, dtype_name="bfloat16")
    chunk = 1 << 18
    for start in range(0, n, chunk):
        m = min(chunk, n - start)
        emb = rows(m).to(torch.bfloat16).view(torch.int16).cpu().numpy().view(np.uint16)
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
        zero_launches(topk)
        out = {k: fused_topk(emb, q, k) for k in (12, 48)}
        torch.cuda.synchronize()
        launches = dict(topk.DTYPE_LAUNCHES)
        check(launches[key] > 0, f"the stream kernel ran on its path ({key})")
        counted[key] = launches[key]
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
    from evossearch_tpu_torch.engine import SearchEngine, _canon
    from evossearch_tpu_torch.index.search import exact_search_host_reader_batch
    from evossearch_tpu_torch.index.store import IndexReader

    folder = work / f"store_{N_SQ8}"
    t0 = time.perf_counter()
    write_store(folder, N_SQ8, gen)
    store_s = time.perf_counter() - t0
    cfg = config_with(work, EVOSSEARCH_HBM_BUDGET_MB=str(SQ8_BUDGET_MB),
                      EVOSSEARCH_SQ8_SYNC_ROWS=str(2 * N_SQ8))
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

    zero_launches(topk)
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
    launches = dict(topk.DTYPE_LAUNCHES)
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


def openai_state_dict(spec, seed: int, visual: bool = True) -> dict:
    """A seeded state dict in the OpenAI release layout for a ViT ``spec``
    (clip/model.py's key names and shapes: ``visual.conv1.weight`` (width,
    3, patch, patch), fused ``attn.in_proj_weight`` (3 width, width), ...)
    with fp16 tensors, as the release files hold them; standard deviations
    of OpenAI's init scheme. ``visual=False``: the text tower's keys
    alone (any spec)."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}

    def t(key, *shape, std, base=0.0):
        sd[key] = (base + std * torch.randn(*shape, generator=gen)).half()

    def tower(prefix, width, layers):
        for i in range(layers):
            p = f"{prefix}.resblocks.{i}"
            for ln in ("ln_1", "ln_2"):
                t(f"{p}.{ln}.weight", width, std=0.02, base=1.0)
                t(f"{p}.{ln}.bias", width, std=0.02)
            t(f"{p}.attn.in_proj_weight", 3 * width, width, std=width ** -0.5)
            t(f"{p}.attn.in_proj_bias", 3 * width, std=0.02)
            t(f"{p}.attn.out_proj.weight", width, width,
              std=width ** -0.5 * (2 * layers) ** -0.5)
            t(f"{p}.attn.out_proj.bias", width, std=0.02)
            t(f"{p}.mlp.c_fc.weight", 4 * width, width, std=(2 * width) ** -0.5)
            t(f"{p}.mlp.c_fc.bias", 4 * width, std=0.02)
            t(f"{p}.mlp.c_proj.weight", width, 4 * width,
              std=width ** -0.5 * (2 * layers) ** -0.5)
            t(f"{p}.mlp.c_proj.bias", width, std=0.02)

    tw = spec.text_width
    lns = [("ln_final", tw)]
    if visual:
        vw, patch = spec.vision_width, spec.patch_size
        grid = spec.image_size // patch
        t("visual.conv1.weight", vw, 3, patch, patch, std=(3 * patch * patch) ** -0.5)
        t("visual.class_embedding", vw, std=vw ** -0.5)
        t("visual.positional_embedding", grid * grid + 1, vw, std=vw ** -0.5)
        lns = [("visual.ln_pre", vw), ("visual.ln_post", vw)] + lns
    for ln, width in lns:
        t(f"{ln}.weight", width, std=0.02, base=1.0)
        t(f"{ln}.bias", width, std=0.02)
    if visual:
        tower("visual.transformer", vw, spec.vision_layers)
        t("visual.proj", vw, spec.embed_dim, std=vw ** -0.5)
    t("token_embedding.weight", spec.vocab_size, tw, std=0.02)
    t("positional_embedding", spec.context_length, tw, std=0.01)
    tower("transformer", tw, spec.text_layers)
    t("text_projection", tw, spec.embed_dim, std=tw ** -0.5)
    sd["logit_scale"] = torch.tensor(math.log(1 / 0.07)).half()
    return sd


def native_phase(build_info: dict, build_s: float) -> dict:
    """The host extension's build (started beside nvcc), its libjpeg
    route and what it holds: the scanner always, the JPEG decoders
    whenever the system's libjpeg headers or Pillow's bundled libjpeg are
    found. A decoder that is built must decode here: a libjpeg whose
    struct layout differs from the headers' fails its first decode, which
    the loaders would otherwise count as a Pillow retry."""
    import io as bytes_io

    from PIL import Image

    from evossearch_tpu_torch.preprocess import io

    mod = io.get_native()
    libjpeg = bool(build_info.get("jpeglib_h")) or build_info.get("pillow_libjpeg") is not None
    row = {"phase": "native", "route": build_info.get("route"),
           "jpeglib_h": build_info.get("jpeglib_h"),
           "pillow_libjpeg": build_info.get("pillow_libjpeg"),
           "build_s": build_info.get("seconds"), "build_wall_s": build_s,
           "command": build_info.get("command"),
           "library": str(build_info.get("library")),
           "error": build_info.get("error"),
           "scanner": mod is not None and hasattr(mod, "topk_bf16"),
           "decode": io.has_native_decode()}
    if row["decode"]:
        buf = bytes_io.BytesIO()
        Image.fromarray(np.random.default_rng(0).integers(0, 256, (480, 640, 3), np.uint8)
                        ).save(buf, "JPEG", quality=90)
        h, w, ch, cw, *_ = mod.decode_jpeg_planar(buf.getvalue(), 224)  # raises on failure
        row["planar_decode_480x640_at_224"] = [h, w, ch, cw]
    emit(row)
    check(build_info.get("error") is None, "the native extension built")
    check(mod is not None and row["scanner"], "the native host scanner loaded")
    check(row["decode"] == libjpeg and row["route"] == ("system" if row["jpeglib_h"] else
                                                        "pillow" if libjpeg else "none"),
          "the decode entry points are there exactly when a libjpeg is, by the first route")
    check(not row["decode"] or row["planar_decode_480x640_at_224"] == [240, 320, 120, 160],
          "the native planar decoder decodes a 480x640 JPEG at half scale")
    return row


def checkpoint_convert(work: Path) -> tuple[Path, Path]:
    """A full-width ViT-B/32 checkpoint in the OpenAI layout, from the
    seed, converted to the native npz by the CLI in a subprocess; one
    engine on each file must report ViT-B/32 and give bit-equal image and
    text embeddings (same weights, same card). Returns (pt, npz)."""
    from evossearch_tpu_torch.core import CLIP_MODEL_SPECS, Config
    from evossearch_tpu_torch.engine import SearchEngine

    spec = CLIP_MODEL_SPECS["ViT-B/32"]
    pt, npz = work / "ViT-B-32.pt", work / "ViT-B-32.npz"
    t0 = time.perf_counter()
    sd = openai_state_dict(spec, seed=4)
    torch.save(sd, pt)
    n_params = sum(v.numel() for v in sd.values())
    del sd
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "evossearch_tpu_torch", "convert", str(pt), str(npz)],
        capture_output=True, text=True, timeout=600,
    )
    convert_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"the CLI converted the checkpoint:\n{proc.stderr[-2000:]}")
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    check(report["success"] and report["model"] == "ViT-B/32"
          and report["params"] == n_params and report["out"] == str(npz),
          f"the converter's report names ViT-B/32 ({report})")
    rng = np.random.default_rng(9)
    images = [rng.integers(0, 256, hw + (3,), dtype=np.uint8)
              for hw in ((224, 224), (480, 640), (300, 500))]
    embs, load_s = {}, {}
    for name, path in (("pt", pt), ("npz", npz)):
        cfg = Config(env_path=work / "missing.env")
        cfg.CHECKPOINT_PATH = str(path)
        t0 = time.perf_counter()
        eng = SearchEngine(cfg=cfg, device="cuda")
        torch.cuda.synchronize()
        load_s[name] = time.perf_counter() - t0
        check(eng.spec == spec, f"the engine on the {name} runs ViT-B/32 ({eng.spec.name})")
        embs[name] = (eng.encode_images(images), eng.encode_text("a photo of a dog"))
        eng.close()
        del eng
    torch.cuda.empty_cache()
    equal = all(np.array_equal(a, b) for a, b in zip(embs["pt"], embs["npz"]))
    emit({"phase": "checkpoint_convert", "model": spec.name, "params": n_params,
          "pt_dtype": "float16", "pt_bytes": pt.stat().st_size,
          "npz_bytes": npz.stat().st_size, "pt_write_s": write_s,
          "cli_convert_s": convert_s, "engine_load_s": load_s,
          "embeddings_bit_equal": equal})
    check(equal, "the .pt and npz engines give bit-equal embeddings")
    return pt, npz


def rgb_to_planes(rgb: np.ndarray):
    """BT.601 full-range (JFIF) RGB -> Y and 2x2-box-averaged Cb, Cr (the
    native planar decoder's 4:2:0 layout; odd edges repeat)."""
    x = rgb.astype(np.float32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 128 - 0.168736 * r - 0.331264 * g + 0.5 * b
    cr = 128 + 0.5 * r - 0.418688 * g - 0.081312 * b
    h, w = y.shape

    def box(c):
        c = np.pad(c, ((0, h % 2), (0, w % 2)), mode="edge")
        return (c[0::2, 0::2] + c[1::2, 0::2] + c[0::2, 1::2] + c[1::2, 1::2]) / 4

    def u8(c):
        return np.clip(np.round(c), 0, 255).astype(np.uint8)

    return u8(y), u8(box(cb)), u8(box(cr))


PLANAR_FLIP_SHARE = 1e-3  # values allowed past PLANAR_ATOL: round-half flips
PLANAR_ATOL = 1e-4        # normalized units, elsewhere


def planar_device(engine) -> dict:
    """The planar device preprocess on the card against the same function
    on the CPU, over 128 mixed-size seeded images split into 4:2:0 planes
    here (so the phase runs with or without libjpeg); then
    encode_prepared_planar against encode_prepared on the same batch."""
    from evossearch_tpu_torch.preprocess import (
        device_preprocess_planar_indexed,
        prepare_batch,
        prepare_batch_planar,
    )

    rng = np.random.default_rng(11)
    sizes = [(480, 640), (640, 480), (224, 224), (300, 500), (768, 1024),
             (375, 500), (512, 512), (333, 251)]
    images = []
    for i in range(128):
        h, w = sizes[i % len(sizes)]
        base = rng.integers(0, 256, (h // 16 + 1, w // 16 + 1, 3), dtype=np.uint8)
        big = np.repeat(np.repeat(base, 16, 0), 16, 1)[:h, :w].astype(np.float32)
        images.append(np.clip(big + rng.normal(0, 8, big.shape), 0, 255).astype(np.uint8))
    planes = [rgb_to_planes(a) for a in images]
    t0 = time.perf_counter()
    prepared = prepare_batch_planar(planes, target=224)
    prepare_s = time.perf_counter() - t0
    rgb_prepared = prepare_batch(images, target=224)
    cpu = device_preprocess_planar_indexed(*(torch.from_numpy(a) for a in prepared))
    gpu = device_preprocess_planar_indexed(
        *(torch.from_numpy(a).cuda() for a in prepared)).cpu()
    diff = (gpu - cpu).abs()
    flips = float((diff > PLANAR_ATOL).float().mean())
    planar_ms = time_ms(lambda: engine.encode_prepared_planar(*prepared), reps=10)
    rgb_ms = time_ms(lambda: engine.encode_prepared(*rgb_prepared), reps=10)
    row = {"phase": "planar_device", "images": len(images),
           "max_abs_err_vs_cpu": float(diff.max()), "share_past_atol": flips,
           "atol": PLANAR_ATOL, "flip_share_limit": PLANAR_FLIP_SHARE,
           "prepare_batch_planar_s": prepare_s,
           "planar_canvas_bytes": int(prepared[0].nbytes + prepared[1].nbytes),
           "rgb_canvas_bytes": int(rgb_prepared[0].nbytes),
           "encode_prepared_planar_ms": planar_ms, "encode_prepared_ms": rgb_ms}
    emit(row)
    check(gpu.shape == (128, 224, 224, 3) and bool(torch.isfinite(gpu).all()),
          "the planar preprocess gave finite (128, 224, 224, 3) values")
    check(flips <= PLANAR_FLIP_SHARE and float(diff.max()) <= 2 / (255 * 0.26130258) + PLANAR_ATOL,
          "the card's planar preprocess agrees with the CPU's")
    return row


def index_run(client, engine, imgs: Path, mode: str) -> dict:
    """One /index of the 64 photos, split into decode, host prepare and
    encode (upload, device preprocess, image tower and the copy back),
    host clock, from the engine's stage timers, with the decode routes
    counted."""
    stages = ("index_decode", "index_prepare", "prep_encode", "prep_encode_fetch")
    before_t = dict(engine.timers.totals)
    before_c = engine.counters.snapshot()
    t0 = time.perf_counter()
    r = client.post("/index", json_body={"folder": str(imgs)})
    wall = time.perf_counter() - t0
    check(r.status_code == 200 and r.json == {"success": True, "count": 64},
          f"/index ({mode}) indexed 64 images ({r.status_code} {r.json})")
    spent = {s: engine.timers.totals.get(s, 0.0) - before_t.get(s, 0.0) for s in stages}
    counts = {k: v - before_c.get(k, 0) for k, v in engine.counters.snapshot().items()
              if k.startswith("decode_") and v - before_c.get(k, 0)}
    return {"index_s": wall, "index_images_per_s": 64 / wall,
            "decode_s": spent["index_decode"], "prepare_s": spent["index_prepare"],
            "encode_s": spent["prep_encode"] + spent["prep_encode_fetch"],
            "decode_counts": counts}


def stored_by_path(imgs: Path) -> dict:
    """The folder's stored embeddings (float32) by file path."""
    from evossearch_tpu_torch.index.store import IndexReader, as_float32

    reader = IndexReader.open(imgs)
    return dict(zip(reader.paths, as_float32(reader.embeddings())))


# The defaults (DCT-scaled native planar decode) against Pillow at full
# size and RGB canvases, per photo. The JAX package's own bound, 0.999
# (tests/test_native.py, tests/test_planar.py), is set on smooth images;
# on these photos its decode routes part further at the FHD ones, which
# decode at 1/4 scale: tests/test_torch_planar.py holds the port's
# per-photo cosines to the JAX package's on them (0.99795 at the least,
# in both, with a small model).
DECODE_COS_MIN = 0.998
DECODE_COS_MEDIAN = 0.9999


def index_twice(client, engine, imgs: Path) -> dict:
    """/index of the photo folder with FAST_DECODE=0 PLANAR_JPEG=0 (Pillow
    at full size, RGB canvases), then with the defaults, in turns, twice
    (the first run also pays first-call costs); each split into decode,
    host prepare and encode (upload, device preprocess, image tower and
    the copy back), host clock, from the engine's stage timers, with the
    decode routes counted. The defaults' embeddings are held against the
    Pillow/RGB ones, photo by photo: cosine > DECODE_COS_MIN each and a
    median > DECODE_COS_MEDIAN."""
    import shutil

    from evossearch_tpu_torch.preprocess.io import has_native_decode

    cfg = engine.cfg
    runs: dict = {"pillow_rgb": [], "defaults": []}
    stored = {}
    for mode, fast in (("pillow_rgb", False), ("defaults", True)) * 2:
        cfg.FAST_DECODE = cfg.PLANAR_JPEG = fast
        shutil.rmtree(imgs / cfg.INDEX_FOLDER_NAME, ignore_errors=True)
        runs[mode].append(index_run(client, engine, imgs, mode))
        stored[mode] = stored_by_path(imgs)
    cfg.FAST_DECODE = cfg.PLANAR_JPEG = True
    native = has_native_decode()
    want = "decode_native_planar" if native else "decode_pillow"
    cos = [float(a @ stored["pillow_rgb"][p] / (np.linalg.norm(a)
                                                * np.linalg.norm(stored["pillow_rgb"][p])))
           for p, a in stored["defaults"].items()]
    check(all(r["decode_counts"] == {"decode_pillow": 64} for r in runs["pillow_rgb"]),
          "with FAST_DECODE=0 every photo decoded with Pillow")
    check(all(r["decode_counts"] == {want: 64} for r in runs["defaults"]),
          f"with the defaults every photo took {want}")
    check(len(cos) == 64 and min(cos) > DECODE_COS_MIN
          and statistics.median(cos) > DECODE_COS_MEDIAN,
          f"the defaults' embeddings agree with Pillow/RGB's (min cosine {min(cos)})")
    return {"native_decode": native, **runs,
            "defaults_vs_pillow_rgb_cosine_min": min(cos),
            "defaults_vs_pillow_rgb_cosine_median": statistics.median(cos)}


def host_scan(reader, query: np.ndarray, k: int = 48, reps: int = 3) -> dict:
    """exact_search_host_reader over the 1,048,576-row bf16 store's mmap
    shards: the native scanner against the numpy scan (the path without
    the library), host clock, median of ``reps``."""
    from unittest import mock

    from evossearch_tpu_torch.index.search import exact_search_host_reader
    from evossearch_tpu_torch.preprocess import io

    def timed(fn):
        laps, out = [], None
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            laps.append((time.perf_counter() - t0) * 1e3)
        return out, statistics.median(laps)

    (s, i), native_ms = timed(lambda: exact_search_host_reader(reader, query, k))
    with mock.patch.object(io, "get_native", lambda: None):
        (s_np, i_np), numpy_ms = timed(lambda: exact_search_host_reader(reader, query, k))
    row = {"phase": "host_scan", "n": reader.count, "d": reader.dim, "k": k,
           "store_dtype": "bfloat16", "native_ms": native_ms, "numpy_ms": numpy_ms,
           "max_abs_score_diff": float(np.abs(s - s_np).max())}
    emit(row)
    check(same_ranking(s[None], i[None], s_np[None], i_np[None]),
          "the native host scan equals the numpy scan under the tie contract")
    return row


def cli_path(imgs: Path, npz: Path, engine, text: str, k: int = 12) -> dict:
    """``python -m evossearch_tpu_torch index`` then ``search`` in
    subprocesses on the card, from the converted npz; the printed rows
    must equal the in-process engine's search of the same folder (same
    weights, loaded from the .pt)."""
    env = {key: v for key, v in os.environ.items() if not key.startswith("EVOSSEARCH_")}
    env["EVOSSEARCH_CHECKPOINT"] = str(npz)
    laps = {}
    outs = {}
    for name, argv in (("index", ["index", str(imgs)]),
                       ("search", ["search", str(imgs), text, "-k", str(k)])):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "evossearch_tpu_torch", *argv],
                              capture_output=True, text=True, env=env, timeout=600)
        laps[name] = time.perf_counter() - t0
        check(proc.returncode == 0, f"the CLI's {name} ran:\n{proc.stderr[-2000:]}")
        outs[name] = [json.loads(line) for line in proc.stdout.strip().splitlines()]
    check(outs["index"] == [{"success": True, "count": 64}], f"the CLI indexed 64 ({outs['index']})")
    scores, idx, reader = engine.search_text(str(imgs), text, k)
    want = [{"path": reader.paths[int(i)], "similarity": float(s)} for s, i in zip(scores, idx)]
    emit({"phase": "cli", "index_s": laps["index"], "search_s": laps["search"],
          "rows": len(outs["search"]), "equals_engine": outs["search"] == want})
    check(outs["search"] == want, "the CLI's search printed the engine's rows")
    return outs


TRAIN_PAIRS = 256     # the train phase's captioned folder
TRAIN_BATCH = 32      # its batch (the CLI's default)
TRAIN_LR = 1e-4       # its learning rate, from the npz's random init
TRAIN_CHECK_BATCH = 8  # pairs of the card-against-CPU step
TRAIN_COLOURS = {"red": (220, 40, 40), "green": (40, 200, 60),
                 "blue": (40, 70, 220), "yellow": (230, 210, 40)}
TRAIN_SHAPES = ("circle", "square")


def write_caption_folder(folder: Path, count: int = TRAIN_PAIRS) -> None:
    """Seeded JPEGs of one coloured shape each (4 colours x 2 shapes) on a
    noisy grey ground, at four photo sizes, and ``captions.json``."""
    from PIL import Image

    rng = np.random.default_rng(SEED + 7)
    sizes = [(240, 320), (320, 240), (256, 256), (480, 640)]
    folder.mkdir()
    captions = {}
    for i in range(count):
        colour = list(TRAIN_COLOURS)[i % 4]
        shape = TRAIN_SHAPES[(i // 4) % 2]
        h, w = sizes[(i // 8) % len(sizes)]
        img = rng.normal(128, 20, (h, w, 3))
        r = rng.uniform(0.2, 0.35) * min(h, w)
        cy, cx = rng.uniform(r, h - r), rng.uniform(r, w - r)
        yy, xx = np.mgrid[0:h, 0:w]
        if shape == "circle":
            inside = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
        else:
            inside = (np.abs(yy - cy) <= r) & (np.abs(xx - cx) <= r)
        img[inside] = np.asarray(TRAIN_COLOURS[colour]) + rng.normal(0, 10, (int(inside.sum()), 3))
        name = f"pair_{i:03d}.jpg"
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(folder / name, quality=90)
        captions[name] = f"a photo of a {colour} {shape}"
    (folder / "captions.json").write_text(json.dumps(captions))


def train_cli(folder: Path, out: Path, *extra: str) -> tuple[dict, float]:
    """``python -m evossearch_tpu_torch train`` in a subprocess on the card,
    at TRAIN_BATCH and TRAIN_LR; (its JSON line, its wall seconds)."""
    env = {key: v for key, v in os.environ.items() if not key.startswith("EVOSSEARCH_")}
    argv = [sys.executable, "-m", "evossearch_tpu_torch", "train", str(folder),
            "--out", str(out), "--batch-size", str(TRAIN_BATCH), "--lr", str(TRAIN_LR),
            "--device", "cuda", *extra]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, capture_output=True, text=True, env=env, timeout=600)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"the CLI trained ({' '.join(extra)}):\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1]), wall


def loss_and_grads(model, images, tokens, dtype, remat=True):
    """One loss and its gradients (float64 on the host, by name)."""
    from evossearch_tpu_torch.train import clip_loss

    model.zero_grad(set_to_none=True)
    loss = clip_loss(model, images, tokens, dtype, remat)
    loss.backward()
    return float(loss.detach()), {n: p.grad.detach().double().cpu()
                                  for n, p in model.named_parameters()}


def grad_cosines(a: dict, b: dict) -> dict:
    return {n: float(a[n].ravel() @ b[n].ravel()
                     / (torch.linalg.norm(a[n]) * torch.linalg.norm(b[n]))) for n in a}


def train_step_times(model, spec, batch: int, dtype) -> dict:
    """The f32 (or bf16) train step with remat at ``batch`` pairs on the
    card: CUDA-event median of 10 steps after 3 warm-up steps, and the
    peak memory allocated over them: in all (the process holds little
    else by then), and over what was allocated before the optimizer's
    state (the parameters, and the batch)."""
    from evossearch_tpu_torch.train import make_optimizer, make_train_step

    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    images = torch.randn(batch, spec.image_size, spec.image_size, 3, generator=gen,
                         device="cuda").to(dtype)
    tokens = torch.randint(1, spec.vocab_size - 1, (batch, spec.context_length),
                           generator=gen, device="cuda")
    tokens[:, 12] = spec.vocab_size - 1  # eot = max id
    model.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    opt = make_optimizer(learning_rate=1e-6)
    state = opt.init(model)
    step = make_train_step(spec, opt, compute_dtype=dtype)
    ms = time_ms(lambda: step(model, state, images, tokens), reps=10, warmup=3)
    peak = torch.cuda.max_memory_allocated()
    del state
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    return {"batch": batch, "dtype": str(dtype).split(".")[-1], "remat": True,
            "step_ms": ms, "pairs_per_s": batch / ms * 1e3, "peak_allocated_bytes": peak,
            "allocated_before_bytes": base, "peak_over_before_bytes": peak - base}


def train_phase(topk, npz: Path, work: Path) -> dict:
    """Contrastive training (A15) at ViT-B/32 full width, from the npz
    that checkpoint_convert wrote, with the launch counts set to 0 just
    before and read just after (the path runs none of the kernels):

      * a seeded caption folder (TRAIN_PAIRS JPEGs, 4 colours x 2
        shapes); the CLI's ``train`` in a subprocess for 2 epochs, then
        ``--resume`` for 1: the loss falls and the epochs continue;
      * ``clip.npz`` in an engine that indexes the folder and answers a
        text search; retrieval_accuracy before and after training;
      * one f32 loss and gradient on the card against the CPU's (same
        weights, same preprocessed batch), with TF32 off; remat on
        against off on the card; a bf16 step on the card against the
        CPU's bf16;
      * step times and peak memory at batch 32 and 256 (f32, remat), and
        the bf16 step at batch 32.
    Returns the kernels' launches on this path."""
    from evossearch_tpu_torch.core import CLIP_MODEL_SPECS, Config
    from evossearch_tpu_torch.engine import SearchEngine
    from evossearch_tpu_torch.models import load_model
    from evossearch_tpu_torch.preprocess import device_preprocess_indexed
    from evossearch_tpu_torch.tokenizer import load_tokenizer
    from evossearch_tpu_torch.train import PairDataset, retrieval_accuracy

    zero_launches(topk)
    spec = CLIP_MODEL_SPECS["ViT-B/32"]
    folder, out = work / "pairs", work / "train_out"
    t0 = time.perf_counter()
    write_caption_folder(folder)
    row = {"phase": "train", "model": spec.name, "pairs": TRAIN_PAIRS, "batch": TRAIN_BATCH,
           "lr": TRAIN_LR, "folder_written_s": time.perf_counter() - t0}

    first, row["cli_2_epochs_s"] = train_cli(folder, out, "--init-from", str(npz), "--epochs", "2")
    with np.load(out / "train_state.npz") as data:
        first_state = (int(data["epoch"]), int(data["opt_0"]))
    resumed, row["cli_resume_1_epoch_s"] = train_cli(folder, out, "--resume", "--epochs", "1")
    with np.load(out / "train_state.npz") as data:
        resumed_state = (int(data["epoch"]), int(data["opt_0"]))
    steps = TRAIN_PAIRS // TRAIN_BATCH
    history = first["loss_history"] + resumed["loss_history"]
    row.update(loss_history=history, epoch_and_count_after_first=first_state,
               epoch_and_count_after_resume=resumed_state)
    check(first["success"] and first["model"] == spec.name and len(history) == 3,
          f"the CLI's JSON lines ({first}, {resumed})")
    check(history[0] > history[1] > history[2], f"the loss falls across the epochs ({history})")
    check(first_state == (1, 2 * steps) and resumed_state == (2, 3 * steps),
          "the resumed run continued the epoch numbering and the optimizer's count")

    tokenizer = load_tokenizer(None)
    batches = list(PairDataset(folder, tokenizer, spec, batch_size=TRAIN_BATCH, seed=SEED).epoch())
    init, _ = load_model(npz, device="cuda")
    trained, trained_spec = load_model(out / "clip.npz", device="cuda")
    check(trained_spec == spec, "clip.npz holds ViT-B/32")
    row["retrieval_accuracy_before"] = retrieval_accuracy(init, spec, batches)
    row["retrieval_accuracy_after"] = retrieval_accuracy(trained, spec, batches)
    check(row["retrieval_accuracy_after"] > row["retrieval_accuracy_before"],
          "training raised the in-batch retrieval accuracy")

    cfg = Config(env_path=work / "missing.env")
    cfg.CHECKPOINT_PATH = str(out / "clip.npz")
    eng = SearchEngine(cfg=cfg, device="cuda")
    count = eng.index_folder(str(folder))
    scores, idx, reader = eng.search_text(str(folder), "a photo of a red circle", 8)
    captions = json.loads((folder / "captions.json").read_text())
    row["search_top8_captions_matching"] = sum(
        captions[Path(reader.paths[int(i)]).name] == "a photo of a red circle" for i in idx)
    eng.close()
    del eng
    check(count == TRAIN_PAIRS and len(scores) == 8 and np.isfinite(scores).all(),
          "an engine on the trained clip.npz indexed the folder and answered /search")

    # the card against the CPU: one batch, preprocessed once on the CPU
    canv, a_h, a_w, size_idx, tokens = batches[0]
    n = TRAIN_CHECK_BATCH
    images = device_preprocess_indexed(*(torch.from_numpy(a) for a in (canv[:n], a_h, a_w,
                                                                       size_idx[:n])))
    tokens = torch.from_numpy(tokens[:n])
    cpu, _ = load_model(out / "clip.npz", device="cpu")
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "TF32 is off for float32 products")
    loss_c, g_c = loss_and_grads(cpu, images, tokens, torch.float32)
    loss_g, g_g = loss_and_grads(trained, images.cuda(), tokens.cuda(), torch.float32)
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "TF32 stayed off through the step")
    cos = grad_cosines(g_g, g_c)
    loss_n, g_n = loss_and_grads(trained, images.cuda(), tokens.cuda(), torch.float32, remat=False)
    remat_rel = max(float(torch.linalg.norm(g_n[k] - g_g[k]) / torch.linalg.norm(g_g[k]))
                    for k in g_g)
    loss_cb, g_cb = loss_and_grads(cpu, images, tokens, torch.bfloat16)
    loss_gb, g_gb = loss_and_grads(trained, images.cuda(), tokens.cuda(), torch.bfloat16)
    cos_b = grad_cosines(g_gb, g_cb)
    del cpu, g_c, g_g, g_n, g_cb, g_gb
    row.update(
        f32_loss_gpu=loss_g, f32_loss_cpu=loss_c, f32_loss_rel_diff=abs(loss_g - loss_c) / loss_c,
        f32_grad_cosine_min=min(cos.values()), f32_grad_cosine_min_leaf=min(cos, key=cos.get),
        remat_off_loss_rel_diff=abs(loss_n - loss_g) / loss_g, remat_off_grad_rel_diff_max=remat_rel,
        bf16_loss_gpu=loss_gb, bf16_loss_cpu=loss_cb, bf16_grad_cosine_min=min(cos_b.values()),
        bf16_grad_cosine_min_leaf=min(cos_b, key=cos_b.get))
    check(row["f32_loss_rel_diff"] <= 1e-4 and row["f32_grad_cosine_min"] >= 0.9999,
          "the card's f32 loss and gradients match the CPU's")
    check(row["remat_off_loss_rel_diff"] <= 1e-6 and remat_rel <= 1e-6,
          "remat on and off give the same loss and gradients on the card")
    check(math.isfinite(loss_gb) and row["bf16_grad_cosine_min"] >= 0.99,
          "the card's bf16 gradients match the CPU's bf16")

    del init
    torch.cuda.empty_cache()
    row["times"] = [train_step_times(trained, spec, 32, torch.float32),
                    train_step_times(trained, spec, 256, torch.float32),
                    train_step_times(trained, spec, 32, torch.bfloat16)]
    del trained
    torch.cuda.empty_cache()
    row["launches"] = dict(topk.DTYPE_LAUNCHES)
    emit(row)
    return row["launches"]


TRAIN_MESH_SHAPES = ((4, 1), (2, 2), (1, 4))  # (data, model) over [cuda:0] * 4
TRAIN_MESH_LR = 1e-3  # the JAX package's rule for its sharded step is set at this rate
TRAIN_MESH_LOSS_ATOL, TRAIN_MESH_PARAM_ATOL = 1e-5, 2e-5  # tests/test_train.py:70-72
TRAIN_MESH_QUERIES = 3  # exact_search over the 1,048,576-row store


def by_tree_key(named: dict) -> dict:
    """Per-layer tensors by module name, stacked by the param pytree's key."""
    from evossearch_tpu_torch.models.checkpoint import tree_key

    out, layers = {}, {}
    for name, t in named.items():
        key, layer = tree_key(name)
        if layer is None:
            out[key] = t
        else:
            layers.setdefault(key, {})[layer] = t
    for key, per_layer in layers.items():
        out[key] = torch.stack([per_layer[i] for i in range(len(per_layer))])
    return out


def leaf_cosines(a: dict, b: dict) -> dict:
    return {k: float(a[k].double().ravel() @ b[k].double().ravel()
                     / (torch.linalg.norm(a[k].double()) * torch.linalg.norm(b[k].double())))
            for k in b}


def mesh_step_times(step, model, state, images, tokens) -> dict:
    """The step's CUDA-event median of 5 after 2 warm-up steps, and the
    peak memory allocated over them above what was held before."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(lambda: step(model, state, images, tokens), reps=5, warmup=2)
    return {"step_ms": ms, "pairs_per_s": images.shape[0] / ms * 1e3,
            "allocated_before_bytes": base,
            "peak_over_before_bytes": torch.cuda.max_memory_allocated() - base}


def train_mesh_phase(topk, search, npz: Path, work: Path) -> dict:
    """The mesh half of training (the rest of A13) at ViT-B/32 full width,
    f32 with remat, on the train phase's caption folder and the converted
    npz, with the launch counts set to 0 just before and read just after
    exact_search (training runs none of the kernels):

      * one step at batch TRAIN_BATCH on the (data, model) meshes
        TRAIN_MESH_SHAPES over [cuda:0] * 4 against the one-device step on
        the same weights and batch, TF32 off: the loss difference, the
        cosine of every reduced gradient leaf to the one-device one, the
        largest parameter difference after the step and its leaf, step
        ms and peak memory; held to the JAX package's rule for its own
        sharded step (loss within 1e-5, params within 2e-5 at lr 1e-3);
      * one bf16 gradient on (2, 2) against the one-device bf16 one, by
        cosine;
      * ``fit`` on train_mesh(devices=[cuda:0] * 4, model_parallel=2) for
        one epoch: a finite loss, its clip.npz in an engine, then one
        epoch resumed on one device;
      * save_sharded of the (2, 2) params and Adam state, load_sharded onto
        (2, 2) and onto (4, 1), bit for bit, with bytes and seconds;
      * ``index.search.exact_search`` of TRAIN_MESH_QUERIES queries over the
        1,048,576-row store (B1), equal to best_exact_search_batch's rows.
    Returns the kernels' launches on this phase's path."""
    from evossearch_tpu_torch.core import CLIP_MODEL_SPECS, Config
    from evossearch_tpu_torch.engine import SearchEngine
    from evossearch_tpu_torch.index.store import IndexReader
    from evossearch_tpu_torch.models import load_params, params_from_numpy
    from evossearch_tpu_torch.models.checkpoint import load_sharded, save_sharded
    from evossearch_tpu_torch.parallel.sharded_search import reader_rows
    from evossearch_tpu_torch.preprocess import device_preprocess_indexed
    from evossearch_tpu_torch.tokenizer import load_tokenizer
    from evossearch_tpu_torch.train import (
        PairDataset,
        ShardedAdamState,
        ShardedCLIP,
        clip_loss,
        fit,
        make_optimizer,
        make_train_step,
        train_mesh,
    )
    from evossearch_tpu_torch.train.sharded import reduce_gradients

    zero_launches(topk)
    t_phase = time.perf_counter()
    spec = CLIP_MODEL_SPECS["ViT-B/32"]
    tree, _ = load_params(npz)
    folder = work / "pairs"
    tokenizer = load_tokenizer(None)
    batch = next(iter(PairDataset(folder, tokenizer, spec, batch_size=TRAIN_BATCH,
                                  seed=SEED).epoch()))
    canv, a_h, a_w, size_idx, tokens = (torch.from_numpy(np.asarray(x)).cuda() for x in batch)
    images = device_preprocess_indexed(canv, a_h, a_w, size_idx)
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "TF32 is off for float32 products")
    row = {"phase": "train_mesh", "model": spec.name, "batch": TRAIN_BATCH, "lr": TRAIN_MESH_LR,
           "devices": "[cuda:0] * 4", "remat": True}

    def grads_of(model, dtype):
        """(loss, gradients by tree key on the card) of one backward pass."""
        model.zero_grad()
        loss = clip_loss(model, images, tokens, dtype, True)
        loss.backward()
        if isinstance(model, ShardedCLIP):
            reduce_gradients(model)
            return float(loss.detach()), model.gather_grads("cuda")
        return float(loss.detach()), by_tree_key({n: p.grad for n, p in model.named_parameters()})

    # the one-device reference: gradients (f32 and bf16), one step, its time
    one = params_from_numpy(tree, spec, "cuda")
    _, g_one = grads_of(one, torch.float32)
    _, g_one_bf16 = grads_of(one, torch.bfloat16)
    opt = make_optimizer(learning_rate=TRAIN_MESH_LR)
    step = make_train_step(spec, opt)
    state = opt.init(one)
    loss_one = float(step(one, state, images, tokens))
    p_one = {k: t.detach().clone() for k, t in by_tree_key(dict(one.named_parameters())).items()}
    row["one_device"] = {"loss": loss_one, **mesh_step_times(step, one, state, images, tokens)}
    del one, state
    torch.cuda.empty_cache()

    meshes, kept = [], None
    for data, model_parallel in TRAIN_MESH_SHAPES:
        mesh = train_mesh(devices=["cuda:0"] * 4, model_parallel=model_parallel)
        sharded = ShardedCLIP.place(tree, mesh, spec)
        loss_g, g = grads_of(sharded, torch.float32)
        cos = leaf_cosines(g, g_one)
        grad_diff = {k: float((g[k] - g_one[k]).abs().max()) for k in g_one}
        del g
        state = opt.init(sharded)
        loss = float(step(sharded, state, images, tokens))
        diffs = {k: float((leaf.gather("cuda") - p_one[k]).abs().max())
                 for k, leaf in sharded.params.items()}
        worst = max(diffs, key=diffs.get)
        entry = {"shape": [data, model_parallel], "loss": loss, "loss_diff": abs(loss - loss_one),
                 "grad_loss_diff": abs(loss_g - loss_one),
                 "grad_cosine_min": min(cos.values()), "grad_cosine_min_leaf": min(cos, key=cos.get),
                 "param_diff_max": diffs[worst], "param_diff_max_leaf": worst,
                 # that leaf's gradient difference beside its magnitude
                 "grad_diff_max_of_that_leaf": grad_diff[worst],
                 "grad_abs_max_of_that_leaf": float(g_one[worst].abs().max()),
                 **mesh_step_times(step, sharded, state, images, tokens)}
        meshes.append(entry)
        emit({"phase": "train_mesh_step", **entry})
        check(entry["loss_diff"] < TRAIN_MESH_LOSS_ATOL
              and entry["param_diff_max"] <= TRAIN_MESH_PARAM_ATOL,
              f"the sharded step on {data}x{model_parallel} matches one device")
        check(entry["grad_cosine_min"] >= 0.9999,
              f"every reduced gradient leaf on {data}x{model_parallel} matches one device")
        if (data, model_parallel) == (2, 2):
            kept = sharded, state
        del sharded, state
        torch.cuda.empty_cache()
    row["meshes"] = meshes

    m22, s22 = kept
    _, g_bf16 = grads_of(ShardedCLIP.place(tree, m22.mesh, spec), torch.bfloat16)
    cos_b = leaf_cosines(g_bf16, g_one_bf16)
    row.update(bf16_2x2_grad_cosine_min=min(cos_b.values()),
               bf16_2x2_grad_cosine_min_leaf=min(cos_b, key=cos_b.get))
    check(row["bf16_2x2_grad_cosine_min"] >= 0.99,
          "the (2, 2) bf16 gradients match the one-device bf16 ones")
    del g_bf16, g_one_bf16, g_one, p_one
    torch.cuda.empty_cache()

    # save_sharded / load_sharded of the (2, 2) run's params and Adam state
    ckpt = work / "mesh_ckpt"
    t0 = time.perf_counter()
    save_sharded(ckpt, {"params": m22, "opt_state": s22})
    row["save_sharded_s"] = time.perf_counter() - t0
    row["save_sharded_bytes"] = sum(f.stat().st_size for f in ckpt.iterdir())
    saved = {**{f"p/{k}": v for k, v in m22.params.items()},
             **{f"mu/{k}": v for k, v in s22.mu.items()},
             **{f"nu/{k}": v for k, v in s22.nu.items()}}
    for model_parallel in (2, 1):
        target = ShardedCLIP.abstract(spec, train_mesh(devices=["cuda:0"] * 4,
                                                       model_parallel=model_parallel))
        t0 = time.perf_counter()
        got = load_sharded(ckpt, {"params": target,
                                  "opt_state": ShardedAdamState.abstract(target)})
        torch.cuda.synchronize()
        name = f"load_sharded_{4 // model_parallel}x{model_parallel}_s"
        row[name] = time.perf_counter() - t0
        restored = {**{f"p/{k}": v for k, v in got["params"].params.items()},
                    **{f"mu/{k}": v for k, v in got["opt_state"].mu.items()},
                    **{f"nu/{k}": v for k, v in got["opt_state"].nu.items()}}
        equal = got["opt_state"].count == s22.count and all(
            torch.equal(shard, saved[key].gather("cuda")[leaf.sharding.index(leaf.shape, pos)])
            for key, leaf in restored.items() for pos, shard in enumerate(leaf.shards))
        check(equal, f"load_sharded onto {4 // model_parallel}x{model_parallel} is bit-equal")
        del got, restored
        torch.cuda.empty_cache()
    del m22, s22, kept, saved
    torch.cuda.empty_cache()

    # fit on (2, 2) for one epoch, its clip.npz in an engine, one epoch
    # resumed on one device
    out = work / "train_mesh_out"
    ds = PairDataset(folder, tokenizer, spec, batch_size=TRAIN_BATCH, seed=SEED)
    t0 = time.perf_counter()
    model, history = fit(spec, ds, epochs=1, learning_rate=TRAIN_LR, params=tree,
                         checkpoint_dir=out, log_every=1000,
                         mesh=train_mesh(devices=["cuda:0"] * 4, model_parallel=2))
    row.update(fit_2x2_s=time.perf_counter() - t0, fit_2x2_loss=history)
    check(isinstance(model, ShardedCLIP) and len(history) == 1 and math.isfinite(history[0]),
          "fit on the (2, 2) mesh ran an epoch with a finite loss")
    del model
    torch.cuda.empty_cache()
    cfg = Config(env_path=work / "missing.env")
    cfg.CHECKPOINT_PATH = str(out / "clip.npz")
    eng = SearchEngine(cfg=cfg, device="cuda")
    count = eng.index_folder(str(folder))
    scores, _, _ = eng.search_text(str(folder), "a photo of a red circle", 8)
    eng.close()
    del eng
    check(count == TRAIN_PAIRS and len(scores) == 8 and np.isfinite(scores).all(),
          "an engine on the mesh run's clip.npz indexed the folder and answered /search")
    t0 = time.perf_counter()
    _, resumed = fit(spec, ds, epochs=1, learning_rate=TRAIN_LR, checkpoint_dir=out,
                     resume=True, log_every=1000, device="cuda")
    with np.load(out / "train_state.npz") as data:
        after = (int(data["epoch"]), int(data["opt_0"]))
    row.update(resume_one_device_s=time.perf_counter() - t0, resume_one_device_loss=resumed,
               epoch_and_count_after_resume=after)
    check(math.isfinite(resumed[0]) and after == (1, 2 * (TRAIN_PAIRS // TRAIN_BATCH)),
          "the mesh run resumed on one device, its optimizer state restored")
    gc.collect()
    torch.cuda.empty_cache()

    # exact_search of single queries over the 1,048,576-row store (B1)
    reader = IndexReader.open(work / "store_1048576")
    emb = reader_rows(reader, 0, reader.count, torch.device("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    queries = torch.nn.functional.normalize(
        torch.randn(TRAIN_MESH_QUERIES, D, generator=gen, device="cuda"), dim=1)
    singles = [search.exact_search(emb, q, Q) for q in queries]
    torch.cuda.synchronize()
    row["launches"] = launches = dict(topk.DTYPE_LAUNCHES)
    want_s, want_i = search.best_exact_search_batch(emb, queries, Q)
    row["exact_search"] = {
        "n": reader.count, "k": Q, "queries": TRAIN_MESH_QUERIES,
        "ids_equal": all(np.array_equal(i, want_i[r]) for r, (_, i) in enumerate(singles)),
        "score_diff_max": max(float(np.abs(s - want_s[r]).max()) for r, (s, _) in enumerate(singles)),
        "launches": {k: v for k, v in launches.items() if v}}
    check(row["exact_search"]["ids_equal"] and row["exact_search"]["score_diff_max"] <= 1e-6,
          "exact_search equals best_exact_search_batch's rows")
    check(launches["tree"] == TRAIN_MESH_QUERIES and sum(launches.values()) == TRAIN_MESH_QUERIES,
          "exact_search took the tree kernel once per query")
    del emb
    torch.cuda.empty_cache()
    row["seconds"] = time.perf_counter() - t_phase
    emit(row)
    return launches


def main_path(topk, search, work: Path) -> tuple[dict, dict, dict]:
    """The three paths, then the train and train_mesh phases from the npz
    they converted, in ``work``, whose stores the sharded phase reads
    later; the paths' engines and threads are freed before the train
    phase measures the card's memory. Returns each kernel's launches on
    the paths, on the train phase and on the train_mesh phase."""
    launches = run_main_path(topk, search, work)
    gc.collect()
    torch.cuda.empty_cache()
    train_launches = train_phase(topk, work / "ViT-B-32.npz", work)
    gc.collect()
    torch.cuda.empty_cache()
    return launches, train_launches, train_mesh_phase(topk, search, work / "ViT-B-32.npz", work)


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
    pt, npz = checkpoint_convert(work)

    # the app starts as users start it: from an OpenAI-layout checkpoint,
    # with the default decode flags
    cfg.CHECKPOINT_PATH = str(pt)
    t0 = time.perf_counter()
    app = create_app(cfg=cfg, device="cuda")
    engine = app.engine
    check(engine.device.type == "cuda", "the app's engine runs on the GPU")
    _ = engine.params
    engine.warmup()
    torch.cuda.synchronize()
    emit({"phase": "model_init", "spec": engine.spec.name, "checkpoint": pt.name,
          "compute_dtype": cfg.COMPUTE_DTYPE, "store_dtype": cfg.STORE_DTYPE,
          "fast_decode": cfg.FAST_DECODE, "planar_jpeg": cfg.PLANAR_JPEG,
          "seconds": time.perf_counter() - t0})
    check(engine.spec.name == "ViT-B/32", "the app runs the checkpoint's ViT-B/32")
    emit(tower_times(engine))
    planar_device(engine)
    client = TestClient(app)

    zero_launches(topk)
    # -- phase 4: the HTTP routes --
    index_runs = index_twice(client, engine, imgs)
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
    emit({"phase": "http_main_path", "images": 64, "index": index_runs,
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
    launches = dict(topk.DTYPE_LAUNCHES)
    emit({"phase": "main_path_launches", "launches": launches})
    check(launches["block"] > 0, "the block kernel ran on the main path")
    check(launches["tree"] > 0, "the tree kernel ran on the main path")
    _, large_reader = engine._cached_index(str(large))
    host_scan(large_reader, engine.encode_text("a photo of a cat"))
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
    cpu_cfg.CHECKPOINT_PATH = str(npz)
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
    cli_path(imgs, npz, engine, "a photo of a dog")
    engine.close()
    return launches


def config_with(work: Path, **env):
    """A Config read from an EVOSSEARCH_* environment of exactly ``env``;
    the process environment is restored after."""
    from evossearch_tpu_torch.core import Config

    saved = {k: v for k, v in os.environ.items() if k.startswith("EVOSSEARCH_")}
    for key in saved:
        del os.environ[key]
    os.environ.update(env)
    try:
        return Config(env_path=work / "missing.env")
    finally:
        for key in env:
            del os.environ[key]
        os.environ.update(saved)


def clustered_rows(gen: torch.Generator, d: int, centres: int):
    """``rows(m)`` for write_store: unit rows scattered around ``centres``
    random unit centres with Gaussian noise of sigma 1.2/sqrt(d) per
    coordinate (tests/test_ivf.py's noise-to-centre ratio), normalized."""
    c = unit_rows(centres, gen, d=d)

    def rows(m):
        pick = torch.randint(0, centres, (m,), generator=gen, device="cuda")
        x = c[pick] + 1.2 / math.sqrt(d) * torch.randn(m, d, generator=gen, device="cuda")
        return x / torch.linalg.norm(x, dim=1, keepdim=True)

    return rows


def ivf_phase(search, work: Path) -> dict:
    """The IVF index (EVOSSEARCH_INDEX_KIND=ivf) over a clustered bf16 store
    of N_IVF rows: the build through an engine (split into its stages),
    recall@48 of the auto nprobe against the exact path on 64 noisy
    queries, the full probe against exact, device IVF against exact at
    Q = 1 and 48 on the same store (CUDA events), the sidecar's save and a
    second engine's reload without retraining, and a third engine under a
    budget below 3x the corpus that serves from the sidecar on the host."""
    from evossearch_tpu_torch.engine import SearchEngine, _canon
    from evossearch_tpu_torch.index.search import exact_search_host_reader
    from evossearch_tpu_torch.index.store import IndexReader

    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    folder = work / "store_ivf"
    t0 = time.perf_counter()
    write_store(folder, N_IVF, gen, rows=clustered_rows(gen, D, IVF_CENTRES))
    store_s = time.perf_counter() - t0
    reader = IndexReader.open(folder)
    emb_d = torch.from_numpy(np.ascontiguousarray(reader.embeddings())).view(
        torch.bfloat16).cuda()
    pick = torch.randint(0, N_IVF, (IVF_QUERIES,), generator=gen, device="cuda")
    queries = emb_d[pick].float() + 0.05 * torch.randn(
        IVF_QUERIES, D, generator=gen, device="cuda")
    queries = queries / torch.linalg.norm(queries, dim=1, keepdim=True)
    q_np = queries.cpu().numpy()
    sidecar = folder / ".clip_index" / "ivf.npz"
    k = 48

    cfg = config_with(work, EVOSSEARCH_INDEX_KIND="ivf")
    eng = SearchEngine(cfg=cfg, device="cuda")
    t0 = time.perf_counter()
    first = eng.search_embedding(str(folder), q_np[0], k)
    first_s = time.perf_counter() - t0
    entry = eng._index_cache[_canon(str(folder))]
    ivf = entry["ivf"]
    check(eng.counters.snapshot().get("ivf_builds") == 1 and sidecar.exists(),
          "the engine built the IVF once and persisted its sidecar")
    check(entry["device_bytes"] == 3 * N_IVF * D * 2 and "emb" not in entry,
          "the engine reserved 3x the corpus for the IVF and holds no exact copy")
    auto = ivf.resolve_nprobe(k)
    s, i = ivf.search_batch(queries, k)
    es, ei = search.best_exact_search_batch(emb_d, queries, k)
    recall = float(np.mean([len(set(a) & set(b)) / k for a, b in zip(i.tolist(), ei.tolist())]))
    check(recall >= 0.99, f"IVF recall@{k} at the auto nprobe {auto} >= 0.99 ({recall})")
    check(np.array_equal(first[1], i[0][i[0] >= 0]),
          "the engine's IVF search equals IVFIndex.search_batch")
    fs, fi = ivf.search_batch(queries[:8], k, nprobe=ivf.nlist)
    check(same_ranking(fs, fi, es[:8], ei[:8]),
          "IVF at nprobe = nlist equals the exact top-k (scores within 1e-5)")
    times = {
        "ivf_ms_q1": time_ms(lambda: ivf.search_batch(queries[:1], k), reps=10),
        "ivf_ms_q48": time_ms(lambda: ivf.search_batch(queries[:Q], k), reps=5),
        "exact_ms_q1": time_ms(lambda: search.best_exact_search_batch(emb_d, queries[:1], k)),
        "exact_ms_q48": time_ms(lambda: search.best_exact_search_batch(emb_d, queries[:Q], k)),
    }
    t0 = time.perf_counter()
    ivf.save(work / "ivf_copy.npz")
    save_s = time.perf_counter() - t0
    (work / "ivf_copy.npz").unlink()
    eng.close()

    eng2 = SearchEngine(cfg=config_with(work, EVOSSEARCH_INDEX_KIND="ivf"), device="cuda")
    t0 = time.perf_counter()
    again = eng2.search_embedding(str(folder), q_np[0], k)
    reload_s = time.perf_counter() - t0
    check("ivf_builds" not in eng2.counters.snapshot()
          and np.array_equal(again[1], first[1]),
          "a second engine reloaded the sidecar without retraining, same ids")
    eng2.close()
    del eng2

    eng3 = SearchEngine(cfg=config_with(work, EVOSSEARCH_INDEX_KIND="ivf",
                                        EVOSSEARCH_HBM_BUDGET_MB=str(IVF_BUDGET_MB)),
                        device="cuda")
    host_ms, exact_host_ms = [], []
    for j in range(8):
        t0 = time.perf_counter()
        hs, hi, _ = eng3.search_embedding(str(folder), q_np[j], k)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        check(same_ranking(hs[None], hi[None], s[j:j + 1], i[j:j + 1]),
              f"the host IVF probe equals the device IVF (query {j})")
    for j in range(3):
        t0 = time.perf_counter()
        exact_search_host_reader(reader, q_np[j], k)
        exact_host_ms.append((time.perf_counter() - t0) * 1e3)
    snap = eng3.counters.snapshot()
    entry3 = eng3._index_cache[_canon(str(folder))]
    check(snap.get("ivf_host_queries") == 8 and snap.get("host_routed_queries") == 8
          and entry3.get("device_bytes", 0) == 0,
          "the over-budget folder was served by the host IVF probe, counted, "
          "with no device bytes")
    eng3.close()
    row = {"phase": "ivf", "n": N_IVF, "d": D, "store_dtype": "bfloat16",
           "centres": IVF_CENTRES, "store_written_s": store_s,
           "nlist": ivf.nlist, "cap": ivf.buckets.shape[1], "spill": ivf.spill.shape[0],
           "build_s": ivf.build_s, "first_search_s": first_s,
           "tuned_nprobe": ivf.tuned_nprobe, "auto_nprobe_k48": auto,
           "recall_at_48": recall, "full_probe_equals_exact": True,
           "full_probe_ids_identical": bool(np.array_equal(fi, ei[:8])), **times,
           "sidecar_bytes": sidecar.stat().st_size, "save_s": save_s,
           "reload_first_search_s": reload_s, "budget_mb": IVF_BUDGET_MB,
           "host_ivf_ms": host_ms, "host_ivf_ms_median": statistics.median(host_ms),
           "exact_host_scan_ms_median": statistics.median(exact_host_ms),
           "ivf_host_queries": snap.get("ivf_host_queries"),
           "exact_faster_on_card_q1": times["exact_ms_q1"] < times["ivf_ms_q1"],
           "exact_faster_on_card_q48": times["exact_ms_q48"] < times["ivf_ms_q48"]}
    emit(row)
    del emb_d, ivf, entry
    torch.cuda.empty_cache()
    return row


SHARDED_QS = (Q, 1, 129)  # query batches of the sharded exact search


def host_ms(fn, reps: int = 5) -> float:
    """Median host-clock ms of ``fn`` (which ends in host numpy) over
    ``reps`` runs after one warm-up."""
    fn()
    laps = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        laps.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(laps)


def sharded_exact(topk, search, reader, n_blocks: int, queries: torch.Tensor,
                  counted: dict) -> dict:
    """``parallel.ShardedIndex`` over ``reader`` in ``n_blocks`` row blocks
    of cuda:0, at each of SHARDED_QS query batches and k = 48, its launches
    added to ``counted``; then, uncounted, the single-device route on the
    same rows: the same ranking, the largest score difference, ids equal,
    CUDA-event ms of both, and the host merge's ms."""
    from evossearch_tpu_torch.parallel import ShardedIndex, corpus_mesh
    from evossearch_tpu_torch.parallel.sharded_search import merge_candidates

    k = 48
    sh = ShardedIndex.from_reader(reader, mesh=corpus_mesh(devices=["cuda:0"] * n_blocks))
    check(sum(b.shape[0] for b in sh.blocks) == reader.count
          and all(b.device == torch.device("cuda", 0) for b in sh.blocks),
          f"the {n_blocks} blocks hold the {reader.count} rows on the card")
    fb0 = search.DISPATCH_COUNTS["fallback"]
    zero_launches(topk)
    got = {nq: sh.search_batch(queries[:nq], k) for nq in SHARDED_QS}
    torch.cuda.synchronize()
    for name, v in topk.DTYPE_LAUNCHES.items():
        counted[name] += v
    launches = {name: v for name, v in topk.DTYPE_LAUNCHES.items() if v}
    fallbacks = search.DISPATCH_COUNTS["fallback"] - fb0
    route = ("tree" if topk.use_tree_kernel(sh.rows, k, torch.bfloat16) else "block") \
        if sh.rows >= 1 << 18 else "dense"
    emb_d = torch.cat(sh.blocks)  # the single device's copy of the same rows
    row = {"n": reader.count, "blocks": n_blocks, "rows_per_block": sh.rows,
           "block_route": route, "launches": launches, "fallback_batches": fallbacks}
    for nq, (s, i) in got.items():
        ws, wi = search.best_exact_search_batch(emb_d, queries[:nq], k)
        check(same_ranking(s, i, ws, wi),
              f"sharded x{n_blocks} over {reader.count} rows at Q = {nq} ranks as the "
              "single device")
        row[f"q{nq}_max_score_diff"] = float(np.abs(s - ws).max())
        row[f"q{nq}_ids_equal"] = bool(np.array_equal(i, wi))
    q = queries[:Q]
    row["ms_q48"] = time_ms(lambda: sh.search_batch(q, k), reps=10)
    row["single_ms_q48"] = time_ms(lambda: search.best_exact_search_batch(emb_d, q, k), reps=10)
    parts = [search.best_exact_search_batch(b, q, k) for b in sh.blocks]
    cs = np.concatenate([p[0] for p in parts], axis=1)
    ci = np.concatenate([p[1] + j * sh.rows for j, p in enumerate(parts)], axis=1)
    row["merge_ms_q48"] = host_ms(lambda: merge_candidates(cs, ci, k), reps=20)
    del sh, emb_d
    torch.cuda.empty_cache()
    return row


def sharded_phase(topk, search, work: Path) -> dict:
    """The search half of corpus sharding (``parallel/``) on one card, over
    the stores the earlier phases wrote, each sharded piece counted from 0
    (``launches_sharded``) and then held, uncounted, against its
    single-device counterpart:

      * ``ShardedIndex`` on [cuda:0] * S: the 1,048,576-row store at S = 4
        (blocks of 2^18 rows: B2) and S = 3 (ragged: B2), the over-budget
        folder's 2,097,152 rows at S = 2 (B1), Q = 48, 1 and 129;
      * ``SQ8ShardedIndex`` at S = 4 on the over-budget folder's sidecar
        (B3 per block) against the one-device tier, Q = 48 and 129;
      * ``ShardedIVFIndex.build`` at S = 4 over the clustered store: the
        full probe against exact, recall@48 of the calibrated nprobe,
        save and reload, a mesh of the wrong size;
      * the engine under EVOSSEARCH_SEARCH_KERNEL=sharded (one card, one
        block): /search on the photos and text searches over the
        1,048,576-row store against ``best``'s, the over-budget folder
        through SQ8ShardedIndex, INDEX_KIND=ivf writing and reusing
        ivf_mesh1.npz;
      * data-parallel encode of the 64 photos over [cuda:0, cuda:0]
        against one device, f32 and bf16.

    Returns the kernels' launches on these paths."""
    from evossearch_tpu_torch.engine import SearchEngine, _canon
    from evossearch_tpu_torch.index.sq8 import SQ8Index
    from evossearch_tpu_torch.index.store import IndexReader
    from evossearch_tpu_torch.parallel import (
        SQ8ShardedIndex, ShardedIVFIndex, corpus_mesh,
    )
    from evossearch_tpu_torch.preprocess.io import load_image_rgb
    from evossearch_tpu_torch.server import TestClient, create_app
    from evossearch_tpu_torch.utils import Counters

    t_phase = time.perf_counter()
    counted = {name: 0 for name in topk.DTYPE_LAUNCHES}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 40)
    queries = unit_rows(max(SHARDED_QS), gen)
    large = IndexReader.open(work / "store_1048576")
    over = IndexReader.open(work / f"store_{N_SQ8}")
    exact = [sharded_exact(topk, search, large, 4, queries, counted),
             sharded_exact(topk, search, large, 3, queries, counted),
             sharded_exact(topk, search, over, 2, queries, counted)]
    check(exact[0]["block_route"] == exact[1]["block_route"] == "block"
          and exact[2]["block_route"] == "tree",
          "the blocks take B2 at S = 4 and 3 over 1,048,576 rows, B1 at S = 2 over 2,097,152")

    # -- SQ8ShardedIndex at S = 4 on the over-budget folder's sidecar --
    base = SQ8Index.load(over)
    check(base is not None, "the over-budget folder's SQ8 sidecar loads")
    base.counters = Counters()
    base.ensure_device("cuda")
    sq8 = SQ8ShardedIndex(base, corpus_mesh(devices=["cuda:0"] * 4))
    q_np = queries.cpu().numpy()
    zero_launches(topk)
    sq8_got = {nq: sq8.search_batch(q_np[:nq], 48) for nq in (Q, 129)}
    torch.cuda.synchronize()
    sq8_launches = topk.DTYPE_LAUNCHES["sq8"]
    counted["sq8"] += sq8_launches
    check(sq8_launches == 4 * 3, "B3 ran once per block and 128-query chunk (4 x 3)")
    sharded_fallbacks = base.counters.snapshot().get("sq8_fallback_queries", 0)
    bit_equal = {}
    for nq, (s, i) in sq8_got.items():
        ws, wi = base.search_batch(q_np[:nq], 48)
        # a query that one tier certifies and the other sends to the host
        # scan is scored by another summation there: scores within
        # SCORE_ATOL, and whether they are bit-equal is reported
        check(np.array_equal(i, wi) and np.allclose(s, ws, rtol=0, atol=SCORE_ATOL),
              f"SQ8ShardedIndex x4 at Q = {nq} returns the one-device tier's ids and scores")
        bit_equal[f"q{nq}_scores_bit_equal"] = bool(np.array_equal(s, ws))
    sq8_row = {"n": over.count, "blocks": 4, "launches_sq8": sq8_launches, **bit_equal,
               "fallback_queries_sharded": sharded_fallbacks,
               "ms_q48": time_ms(lambda: sq8.search_batch(q_np[:Q], 48), reps=10),
               "one_device_ms_q48": time_ms(lambda: base.search_batch(q_np[:Q], 48),
                                            reps=10),
               "ms_q129": time_ms(lambda: sq8.search_batch(q_np, 48), reps=5)}
    del sq8, base
    torch.cuda.empty_cache()

    # -- ShardedIVFIndex at S = 4 over the clustered store --
    ivf_reader = IndexReader.open(work / "store_ivf")
    mesh4 = corpus_mesh(devices=["cuda:0"] * 4)
    t0 = time.perf_counter()
    ivf = ShardedIVFIndex.build(ivf_reader.embeddings(), mesh=mesh4, pre_normalized=True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    emb_d = torch.from_numpy(np.ascontiguousarray(ivf_reader.embeddings())).view(
        torch.bfloat16).cuda()
    pick = torch.randint(0, ivf_reader.count, (IVF_QUERIES,), generator=gen, device="cuda")
    iq = emb_d[pick].float() + 0.05 * torch.randn(IVF_QUERIES, D, generator=gen, device="cuda")
    iq = iq / torch.linalg.norm(iq, dim=1, keepdim=True)
    zero_launches(topk)
    s, i = ivf.search_batch(iq, 48)
    fs, fi = ivf.search_batch(iq[:8], 48, nprobe=ivf.nlist)
    es, ei = search.best_exact_search_batch(emb_d, iq, 48)
    recall = float(np.mean([len(set(a) & set(b)) / 48 for a, b in zip(i.tolist(), ei.tolist())]))
    check(same_ranking(fs, fi, es[:8], ei[:8]),
          "the sharded IVF at nprobe = nlist equals the exact top-k (scores within 1e-5)")
    check(recall >= 0.995, f"sharded IVF recall@48 at the calibrated nprobe "
          f"{ivf.tuned_nprobe} >= the tune target 0.995 ({recall})")
    side = work / "ivf_mesh4.npz"
    ivf.save(side)
    again = ShardedIVFIndex.load(side, mesh=mesh4)
    check(again is not None and np.array_equal(again.search_batch(iq, 48)[1], i),
          "the sharded IVF saved and reloaded gives the same results")
    check(ShardedIVFIndex.load(side, mesh=corpus_mesh(devices=["cuda:0"] * 2)) is None,
          "a mesh of the wrong size loads None")
    ivf_row = {"n": ivf_reader.count, "blocks": 4, "nlist": ivf.nlist,
               "cap": ivf.buckets[0].shape[1], "spill_per_block": ivf.spill[0].shape[0],
               "build_s": build_s, "tuned_nprobe": ivf.tuned_nprobe,
               "recall_at_48": recall, "full_probe_ids_identical": bool(np.array_equal(fi, ei[:8])),
               "sidecar_bytes": side.stat().st_size,
               "ms_q48": time_ms(lambda: ivf.search_batch(iq[:Q], 48), reps=5),
               "exact_ms_q48": time_ms(lambda: search.best_exact_search_batch(emb_d, iq[:Q], 48))}
    side.unlink()
    del ivf, again, emb_d
    torch.cuda.empty_cache()

    # -- the engine and HTTP under EVOSSEARCH_SEARCH_KERNEL=sharded --
    npz = work / "ViT-B-32.npz"
    photos, store = work / "photos", work / "store_1048576"
    zero_launches(topk)
    app = create_app(cfg=config_with(work, EVOSSEARCH_SEARCH_KERNEL="sharded",
                                     EVOSSEARCH_CHECKPOINT=str(npz)), device="cuda")
    eng = app.engine
    check(eng._resolve_kernel() == "sharded" and eng._corpus_mesh().size
          == torch.cuda.device_count(), "the engine serves the sharded kernel, one block a card")
    client = TestClient(app)
    texts = ("a photo of a dog", "a red car")
    http = {t: client.post("/search", json_body={"folder": str(photos), "query": t,
                                                  "limit": 12}).json["results"]
            for t in texts}
    text_res = {k: eng.search_text(str(store), "a photo of a cat", k) for k in (12, 48)}
    entry = eng._index_cache[_canon(str(store))]
    check(entry.get("sharded") is not None and "emb" not in entry,
          "the engine holds the 1,048,576-row store as a ShardedIndex")
    over_eng = SearchEngine(cfg=config_with(
        work, EVOSSEARCH_SEARCH_KERNEL="sharded", EVOSSEARCH_HBM_BUDGET_MB=str(SQ8_BUDGET_MB)),
        spec=eng.spec, params=eng.params, device="cuda")
    over_res = over_eng.search_embedding(str(work / f"store_{N_SQ8}"), q_np[0], 48)
    ivf_cfg = dict(EVOSSEARCH_SEARCH_KERNEL="sharded", EVOSSEARCH_INDEX_KIND="ivf")
    ivf_eng = SearchEngine(cfg=config_with(work, **ivf_cfg), spec=eng.spec,
                           params=eng.params, device="cuda")
    small = work / "store_262144"
    ivf_first = ivf_eng.search_embedding(str(small), q_np[0], 48)
    torch.cuda.synchronize()
    engine_launches = dict(topk.DTYPE_LAUNCHES)
    for name, v in engine_launches.items():
        counted[name] += v
    over_entry = over_eng._index_cache[_canon(str(work / f"store_{N_SQ8}"))]
    check(isinstance(over_entry.get("sq8"), SQ8ShardedIndex) and engine_launches["sq8"] > 0,
          "the over-budget folder is served through SQ8ShardedIndex, B3 launched")
    check(ivf_eng.counters.snapshot().get("ivf_builds") == 1
          and (small / ".clip_index" / "ivf_mesh1.npz").exists(),
          "INDEX_KIND=ivf under sharded built and wrote ivf_mesh1.npz")
    ivf_eng2 = SearchEngine(cfg=config_with(work, **ivf_cfg), spec=eng.spec,
                            params=eng.params, device="cuda")
    ivf_again = ivf_eng2.search_embedding(str(small), q_np[0], 48)
    check("ivf_builds" not in ivf_eng2.counters.snapshot()
          and np.array_equal(ivf_again[1], ivf_first[1]),
          "a second engine reused ivf_mesh1.npz, same ids")
    best = create_app(cfg=config_with(work, EVOSSEARCH_SEARCH_KERNEL="best",
                                      EVOSSEARCH_CHECKPOINT=str(npz)), device="cuda")
    best_client = TestClient(best)
    for t in texts:
        want = best_client.post("/search", json_body={"folder": str(photos), "query": t,
                                                       "limit": 12}).json["results"]

        def rows(res):
            return (np.array([[r["similarity"] for r in res]]),
                    np.array([[r["path"] for r in res]]))

        check(len(http[t]) == 12 and same_ranking(*rows(http[t]), *rows(want)),
              f"/search {t!r} under sharded equals best's")
    for k, (s, i, _) in text_res.items():
        ws, wi, _ = best.engine.search_text(str(store), "a photo of a cat", k)
        check(same_ranking(s[None], i[None], ws[None], wi[None]),
              f"the sharded engine's text search over {store.name} at k = {k} equals best's")
    o_s, o_i = search.exact_search_host_reader_batch(over, q_np[:1], 48)
    check(same_ranking(over_res[0][None], over_res[1][None], o_s, o_i),
          "the over-budget sharded SQ8 search equals the exact host scan")
    engine_row = {"launches": {n: v for n, v in engine_launches.items() if v},
                  "http_search_equals_best": True, "ivf_mesh1_bytes":
                  (small / ".clip_index" / "ivf_mesh1.npz").stat().st_size,
                  "over_budget_sq8_queries": over_eng.counters.snapshot().get("sq8_queries")}
    for e in (eng, over_eng, ivf_eng, ivf_eng2, best.engine):
        e.close()
    del app, best, eng, over_eng, ivf_eng, ivf_eng2, entry, over_entry
    gc.collect()
    torch.cuda.empty_cache()

    # -- data-parallel encode over [cuda:0, cuda:0] --
    images = [load_image_rgb(p) for p in sorted(photos.glob("*.jpg"))]
    dp_row = {"images": len(images)}
    for dtype_name in ("float32", "bfloat16"):
        one = SearchEngine(cfg=config_with(work, EVOSSEARCH_CHECKPOINT=str(npz),
                                           EVOSSEARCH_COMPUTE_DTYPE=dtype_name), device="cuda")
        dp = SearchEngine(cfg=config_with(work, EVOSSEARCH_COMPUTE_DTYPE=dtype_name),
                          spec=one.spec, params=one.params, device="cuda")
        dp.__dict__["_encode_devices"] = [torch.device("cuda", 0)] * 2
        a, b = dp.encode_images(images), one.encode_images(images)
        cos = (a * b).sum(axis=1) / np.linalg.norm(a, axis=1) / np.linalg.norm(b, axis=1)
        if dtype_name == "float32":
            err = float(np.abs(a - b).max())
            check(err <= 1e-5, f"DP encode f32 within 1e-5 of one device ({err})")
            dp_row["f32_max_abs_diff"] = err
        else:
            check(float(cos.min()) >= 0.9999, f"DP encode bf16 cosine >= 0.9999 ({cos.min()})")
            dp_row["bf16_min_cosine"] = float(cos.min())
        one.close()
        dp.close()
    row = {"phase": "sharded", "exact": exact, "sq8": sq8_row, "ivf": ivf_row,
           "engine": engine_row, "dp_encode": dp_row,
           "launches": {n: v for n, v in counted.items() if v},
           "seconds": time.perf_counter() - t_phase}
    emit(row)
    for name in ("block", "tree", "sq8"):
        check(counted[name] > 0, f"the {name} kernel ran on the sharded path")
    return counted


def openai_resnet_state_dict(spec, seed: int) -> dict:
    """A seeded state dict in the OpenAI release layout for a modified-
    ResNet ``spec`` (clip/model.py's ModifiedResNet keys: a three-conv
    stem, ``layer{1..4}`` Bottlenecks whose first block has the
    ``downsample`` shortcut, an ``attnpool``), fp16 as the release files
    hold them. BatchNorm weights, biases and running statistics (var > 0)
    are drawn at random: OpenAI's zero bn3 init would make every residual
    branch vanish. Conv weights have He's scale, sqrt(2 / fan_in), so the
    activations keep their size through the depth: at 1/sqrt(fan_in) the
    random tower maps any two images to embeddings of cosine > 0.999, and
    no search would tell them apart. The text tower is
    openai_state_dict's."""
    gen = torch.Generator().manual_seed(seed + 1)
    sd = openai_state_dict(spec, seed, visual=False)

    def t(key, *shape, std, base=0.0):
        sd[key] = (base + std * torch.randn(*shape, generator=gen)).half()

    def bn(prefix, c):
        t(f"{prefix}.weight", c, std=0.2, base=1.0)
        t(f"{prefix}.bias", c, std=0.1)
        t(f"{prefix}.running_mean", c, std=0.2)
        sd[f"{prefix}.running_var"] = (0.5 + torch.rand(c, generator=gen)).half()
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0)

    def conv(key, cout, cin, kk):
        t(key, cout, cin, kk, kk, std=(2 / (cin * kk * kk)) ** 0.5)

    w = spec.vision_width
    for i, (cin, cout) in enumerate(((3, w // 2), (w // 2, w // 2), (w // 2, w))):
        conv(f"visual.conv{i + 1}.weight", cout, cin, 3)
        bn(f"visual.bn{i + 1}", cout)
    inplanes = w
    for stage, blocks in enumerate(spec.vision_layers):
        planes = w * 2 ** stage
        for j in range(blocks):
            p = f"visual.layer{stage + 1}.{j}"
            conv(f"{p}.conv1.weight", planes, inplanes, 1)
            bn(f"{p}.bn1", planes)
            conv(f"{p}.conv2.weight", planes, planes, 3)
            bn(f"{p}.bn2", planes)
            conv(f"{p}.conv3.weight", planes * 4, planes, 1)
            bn(f"{p}.bn3", planes * 4)
            if j == 0:
                conv(f"{p}.downsample.0.weight", planes * 4, inplanes, 1)
                bn(f"{p}.downsample.1", planes * 4)
            inplanes = planes * 4
    c = spec.attn_dim
    t("visual.attnpool.positional_embedding", spec.num_image_tokens, c, std=c ** -0.5)
    for proj in ("q_proj", "k_proj", "v_proj"):
        t(f"visual.attnpool.{proj}.weight", c, c, std=c ** -0.5)
        t(f"visual.attnpool.{proj}.bias", c, std=0.02)
    t("visual.attnpool.c_proj.weight", spec.embed_dim, c, std=c ** -0.5)
    t("visual.attnpool.c_proj.bias", spec.embed_dim, std=0.02)
    return sd


def resnet_phase(topk, search, work: Path) -> dict:
    """RN50 at its published full width from a seeded OpenAI-layout ``.pt``
    through load_checkpoint into the app on the card: the image tower's
    time per 128-image batch (bf16), the card's f32 (TF32 off inside the
    forward) and bf16 embeddings against the CPU's f32 on 4 images, then,
    with the launch counts set to 0 just before and read just after, the
    HTTP routes on 64 photos and the exact kernels at the tower's
    d = 1024: text searches over a RN50_STORE-row store (block at k = 48,
    tree at k = 12) and, under a lowered budget, the SQ8 tier. Returns the
    kernels' launches on this path."""
    from evossearch_tpu_torch.core import CLIP_MODEL_SPECS
    from evossearch_tpu_torch.engine import SearchEngine
    from evossearch_tpu_torch.models import CLIP, encode_image
    from evossearch_tpu_torch.server import TestClient, create_app

    spec = CLIP_MODEL_SPECS["RN50"]
    d = spec.embed_dim
    t0 = time.perf_counter()
    pt = work / "RN50.pt"
    torch.save(openai_resnet_state_dict(spec, SEED), pt)
    cfg = config_with(work, EVOSSEARCH_CHECKPOINT=str(pt))
    app = create_app(cfg=cfg, device="cuda")
    engine = app.engine
    model = engine.params
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    check(engine.spec == spec and engine.spec.family == "resnet"
          and (spec.image_size, spec.vision_width, spec.vision_layers,
               spec.vision_heads, d) == (224, 64, (3, 4, 6, 3), 32, 1024),
          "the app runs RN50 at its published width from the OpenAI-layout checkpoint")
    towers = tower_times(engine)

    gen = torch.Generator().manual_seed(SEED + 20)
    images = torch.randn(4, spec.image_size, spec.image_size, 3, generator=gen)
    cpu = CLIP(spec)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    want = encode_image(cpu.eval(), images)
    del cpu
    flags = []
    hook = model.visual.stem.conv1.register_forward_pre_hook(
        lambda mod, args: flags.append(torch.backends.cudnn.allow_tf32))
    before = torch.backends.cudnn.allow_tf32
    got32 = encode_image(model, images.cuda(), torch.float32).cpu()
    hook.remove()
    got16 = encode_image(model, images.cuda(), torch.bfloat16).cpu()
    cos32 = (got32 * want).sum(-1)
    cos16 = (got16 * want).sum(-1)
    check(flags == [False] and torch.backends.cudnn.allow_tf32 == before,
          "cuDNN's TF32 was off inside the f32 forward and restored after")
    check(bool((cos32 >= 0.9999).all()), f"RN50 f32 card vs CPU cosine >= 0.9999 ({cos32})")
    check(bool((cos16 >= 0.995).all()), f"RN50 bf16 card vs f32 CPU cosine >= 0.995 ({cos16})")

    imgs = work / "photos_rn50"
    imgs.mkdir()
    jpegs = write_jpegs(imgs, 64)
    store = work / f"store_rn50_{RN50_STORE}"
    gen_d = torch.Generator(device="cuda").manual_seed(SEED + 21)
    t0 = time.perf_counter()
    write_store(store, RN50_STORE, gen_d, d=d, model=spec.name)
    store_s = time.perf_counter() - t0
    client = TestClient(app)
    zero_launches(topk)
    index = index_run(client, engine, imgs, "defaults")
    search_ms, image_ms = [], []
    for text in ("a photo of a dog", "a red car"):
        t0 = time.perf_counter()
        r = client.post("/search", json_body={"folder": str(imgs), "query": text, "limit": 12})
        search_ms.append((time.perf_counter() - t0) * 1e3)
        sims = [x["similarity"] for x in r.json["results"]]
        check(r.status_code == 200 and len(sims) == 12 and sims == sorted(sims, reverse=True),
              f"RN50 /search answered 12 ranked results ({r.status_code})")
    for p in jpegs[:2]:
        t0 = time.perf_counter()
        r = client.post("/search_by_image", data={"folder": str(imgs), "limit": "6"},
                        files={"image": ("query.jpg", p.read_bytes())})
        image_ms.append((time.perf_counter() - t0) * 1e3)
        res = r.json["results"]
        check(r.status_code == 200 and res[0]["filename"] == p.name
              and res[0]["similarity"] > 0.99,
              f"RN50 /search_by_image finds the uploaded {p.name} first")
    results = {}
    for k in (48, 12):
        results[k] = engine.search_text(str(store), "a photo of a cat", k)
    over = SearchEngine(cfg=config_with(
        work, EVOSSEARCH_HBM_BUDGET_MB=str(RN50_SQ8_BUDGET_MB),
        EVOSSEARCH_SQ8_SYNC_ROWS=str(2 * RN50_STORE)), spec=spec, params=model,
        device="cuda")
    t0 = time.perf_counter()
    sq8_res = over.search_text(str(store), "a photo of a cat", 48)
    sq8_first_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = dict(topk.DTYPE_LAUNCHES)
    for name in ("block", "tree", "sq8"):
        check(launches[name] > 0, f"the {name} kernel ran on the RN50 path at d = {d}")
    over_snap = over.counters.snapshot()
    check(over_snap.get("sq8_queries") == 1
          and over_snap.get("sq8_fallback_queries", 0) == 0,
          f"the over-budget d = 1024 folder took the SQ8 tier, certified ({over_snap})")
    # correctness of what came out, against the dense oracle on the card
    entry, reader = engine._cached_index(str(store))
    emb_d = engine._entry_emb(entry, reader)
    q = torch.as_tensor(engine.encode_text("a photo of a cat"), device="cuda")
    for k, (scores, idx, _) in list(results.items()) + [("sq8", sq8_res)]:
        kk = len(idx)
        o_s, o_i = search.exact_search_batch(emb_d, q, kk)
        check(same_ranking(scores[None], idx[None], o_s, o_i),
              f"RN50 store search ({k}) equals the dense oracle")
    row = {"phase": "resnet", "model": spec.name, "image_size": spec.image_size,
           "width": spec.vision_width, "layers": list(spec.vision_layers),
           "heads": spec.vision_heads, "embed_dim": d, "checkpoint_load_s": load_s,
           "image_tower_ms_b128_bf16": towers["image_tower_ms"],
           "image_tower_images_per_s": towers["image_tower_images_per_s"],
           "text_tower_ms_batch1": towers["text_tower_ms_batch1"],
           "f32_cosine_card_vs_cpu": cos32.tolist(),
           "f32_max_abs_diff": float((got32 - want).abs().max()),
           "tf32_inside_f32_forward": flags,
           "bf16_cosine_card_vs_f32_cpu": cos16.tolist(),
           "index": index, "search_ms": search_ms, "search_by_image_ms": image_ms,
           "store_rows": RN50_STORE, "store_written_s": store_s,
           "sq8_budget_mb": RN50_SQ8_BUDGET_MB, "sq8_first_search_s": sq8_first_s,
           "launches": launches}
    emit(row)
    over.close()
    engine.close()
    del emb_d, model, app, engine, over
    torch.cuda.empty_cache()
    return launches


BENCH_PHASES = "search,encode_l14"  # the bench phases the smoke runs
BENCH_TIMEOUT_S = 600


def bench_phase(topk) -> dict:
    """The port's bench as users start it, in a subprocess: ``python -m
    evossearch_tpu_torch.bench --phases search,encode_l14`` (the headline,
    1,000,000 unit f32 rows of d = 512, 48 queries, k = 48; ViT-L/14's
    image tower at batch 64 and its card-against-CPU check). It must exit
    0, print one stdout line with the headline metric and this card's
    name, and log its oracle's and ViT-L/14's checks as passed. Returns
    the bench's launches by kernel and corpus dtype, summed over its
    phases (each phase counts its own from 0)."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "evossearch_tpu_torch.bench", "--phases", BENCH_PHASES],
        capture_output=True, text=True, timeout=BENCH_TIMEOUT_S,
    )
    wall = time.perf_counter() - t0
    err = proc.stderr
    check(proc.returncode == 0, f"the bench exits 0 ({proc.returncode}; {err[-3000:]})")
    out = [line for line in proc.stdout.splitlines() if line.strip()]
    check(len(out) == 1, f"the bench prints one stdout line ({out})")
    head = json.loads(out[0])
    check(head.get("metric") == "exact_top48_per_query_ms_at_1M_vectors_batch48"
          and head.get("unit") == "ms" and head.get("value", 0) > 0,
          f"the bench's headline line ({head})")
    check(head.get("device", {}).get("kind") == torch.cuda.get_device_name(0),
          f"the bench names this card ({head.get('device')})")
    for name in ("search_oracle", "encode_l14_card_vs_cpu", "encode_l14_finite"):
        check(f"check {name} ok" in err, f"the bench's check {name} passed")
    phases = [json.loads(line[len("phase "):]) for line in err.splitlines()
              if line.startswith("phase {")]
    check([p["name"] for p in phases] == BENCH_PHASES.split(",")
          and all(p["ok"] for p in phases), f"the bench's phases ran in order ({phases})")
    launches = {key: sum(p["launches"][key] for p in phases) for key in topk.DTYPE_LAUNCHES}
    check(launches["tree_f32"] > 0, "the headline reached the tree kernel's f32 path")
    emit({"phase": "bench", "seconds": wall, "command": f"python -m evossearch_tpu_torch.bench "
          f"--phases {BENCH_PHASES}", "headline": head, "phases": phases,
          "checks": [line for line in err.splitlines() if line.startswith("check ")],
          "summary": [line[2:] for line in err.splitlines() if line.startswith("| ")]})
    return launches


SCRIPTS = ("exp_merge_variants", "exp_merge_profile", "exp_rn50_profile",
           "exp_index_producer")  # the JAX package's four profilers, ported
HOST_SCRIPTS = ("exp_index_producer",)  # host only: it names the host, not the card
SCRIPTS_TIMEOUT_S = 300


def script_lines(name: str, rows: list[dict]) -> dict:
    """The key lines of one script's JSON rows: the stage table, the top
    device kernels and the idle share, the RN50 segment table, the
    producer against decode-only."""
    if name == "exp_merge_variants":
        return {f"{r['n']} {r['dtype']}": {
            key: r[key] for key in ("tile", "stages_ms", "step_ms", "production_ms",
                                    "production_host_ms", "production_cert_rate",
                                    "alternates", "launches")} for r in rows}
    if name == "exp_merge_profile":
        r = rows[0]
        return {key: r[key] for key in ("n", "dtype", "reps", "idle_share", "device_us",
                                        "window_us", "tracks", "launches", "trace")} | {
            "top_device_ops_us": dict(list(r["ops"].items())[:12])}
    if name == "exp_rn50_profile":
        return {r["measure"]: {k: v for k, v in r.items() if k not in ("ok", "device")}
                for r in rows if r["measure"] != "rn50_batch"} | {
            "batches": {r["batch"]: [r["ms"], r["images_per_s"], r["mfu"]]
                        for r in rows if r["measure"] == "rn50_batch"}}
    return {r["measure"]: {k: r[k] for k in ("best_s", "images_per_s", "runs_s", "routes")}
            for r in rows} | {"host": rows[0]["host"],
                               "share_of_decode_only_rate": rows[1]["share_of_decode_only_rate"],
                               "native_route": rows[1]["native_route"]}


def scripts_phase(topk, smi: str) -> dict:
    """The port's four experiment scripts as users start them, each in a
    subprocess: ``python -m evossearch_tpu_torch.scripts.<name>`` for
    exp_merge_variants (B1's merge by stage at 1M bf16, 1M f32 and 10M
    bf16 rows), exp_merge_profile (torch.profiler over the packed tree
    search), exp_rn50_profile (RN50's segments and batch sweep) and
    exp_index_producer (host only: the stub build against decode-only).
    Each must exit 0 with every JSON row ``ok``; the card scripts must
    print this card's name and power limit (``smi``) and name it in each
    row, the producer must label its numbers as the host's; the profile
    must name B1's kernel among its device ops. Emits each script's key
    lines; returns the launches by kernel and corpus dtype that the
    scripts' rows report, summed."""
    gc.collect()
    torch.cuda.empty_cache()
    launches = dict.fromkeys(topk.DTYPE_LAUNCHES, 0)
    for name in SCRIPTS:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", f"evossearch_tpu_torch.scripts.{name}"],
                              capture_output=True, text=True, timeout=SCRIPTS_TIMEOUT_S)
        wall = time.perf_counter() - t0
        check(proc.returncode == 0,
              f"{name} exits 0 ({proc.returncode}; {proc.stderr[-3000:]}{proc.stdout[-2000:]})")
        lines = proc.stdout.splitlines()
        rows = [json.loads(line) for line in lines if line.startswith("{")]
        check(rows and all(r["ok"] for r in rows), f"{name}'s checks passed ({rows})")
        if name in HOST_SCRIPTS:
            check(lines[0].startswith("host: ") and all(r["clock"] == "host" for r in rows),
                  f"{name} labels its numbers as the host's ({lines[0]})")
        else:
            check(lines[0] == smi and all(r["device"] == torch.cuda.get_device_name(0)
                                          for r in rows),
                  f"{name} names this card ({lines[0]})")
        if name == "exp_merge_profile":
            from evossearch_tpu_torch.scripts.exp_merge_profile import names_tree_kernel

            check(rows[0]["ops_from"] == "device" and names_tree_kernel(rows[0]["ops"]),
                  f"the merge profile names B1's kernel among its device ops ({rows[0]['ops']})")
            Path(rows[0]["trace"]).unlink(missing_ok=True)
            Path(rows[0]["trace"]).parent.rmdir()
        for r in rows:
            for key, v in r.get("launches", {}).items():
                launches[key] += v
        extra = {"profile": [line for line in lines[1:] if not line.startswith("{")]
                 } if name in HOST_SCRIPTS else {}
        emit({"phase": "scripts", "script": name, "seconds": wall,
              "command": f"python -m evossearch_tpu_torch.scripts.{name}",
              **script_lines(name, rows), **extra})
    check(launches["tree"] > 0 and launches["tree_f32"] > 0,
          f"the scripts reached B1's bf16 and f32 paths ({launches})")
    return launches


# the port's copies of the JAX package's engine suites whose cases run on
# the card too (a ``device`` fixture with a ``gpu``-marked "cuda" case)
REFERENCE_SUITES = (
    "tests/test_torch_ref_api_contract.py",
    "tests/test_torch_ref_hbm_budget.py",
    "tests/test_torch_ref_serving.py",
    "tests/test_torch_ref_engine_kernels.py",
    "tests/test_torch_ref_round4_fixes.py",
    "tests/test_torch_ref_review5_fixes.py",
)
REFERENCE_SUITES_LIMIT_S = 180
# the engine's case that must reach the block kernel on the card
REFERENCE_BLOCK_CASE = "test_pallas_kernel_reaches_block[cuda]"


def reference_suites_phase() -> dict:
    """The ``gpu`` cases of REFERENCE_SUITES, as the repo's docs run them
    on a machine without JAX: ``python -m pytest --noconftest -q -p
    no:cacheprovider -m gpu <files>`` in a subprocess, with no
    EVOSSEARCH_* variable of this process. It must exit 0 within
    REFERENCE_SUITES_LIMIT_S with no case skipped, failed or in error,
    every collected case passed, each file passing at least one, and
    REFERENCE_BLOCK_CASE (the engine's search through the block kernel,
    counted in ``ops.topk.DTYPE_LAUNCHES``) among the passes. Emits the
    files, the passed count per file and the seconds."""
    import xml.etree.ElementTree as ET

    gc.collect()
    torch.cuda.empty_cache()
    env = {k: v for k, v in os.environ.items() if not k.startswith("EVOSSEARCH_")}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_suites_") as tmp:
        xml = Path(tmp) / "junit.xml"
        argv = [sys.executable, "-m", "pytest", "--noconftest", "-q", "-p",
                "no:cacheprovider", "-m", "gpu", f"--junitxml={xml}", *REFERENCE_SUITES]
        t0 = time.perf_counter()
        proc = subprocess.run(argv, capture_output=True, text=True, env=env, timeout=600)
        wall = time.perf_counter() - t0
        check(proc.returncode == 0,
              f"the reference suites pass on the card ({proc.returncode}; "
              f"{proc.stdout[-4000:]}{proc.stderr[-2000:]})")
        cases = ET.parse(xml).getroot().iter("testcase")
        outcomes = {}
        for case in cases:
            kind = next((child.tag for child in case
                         if child.tag in ("skipped", "failure", "error")), "passed")
            outcomes[(case.get("classname"), case.get("name"))] = kind
    not_passed = {f"{c}::{n}": kind for (c, n), kind in outcomes.items() if kind != "passed"}
    check(not not_passed, f"every gpu case of the reference suites passed ({not_passed})")
    per_file = {path: sum(1 for (c, _), kind in outcomes.items()
                          if kind == "passed" and c.split(".")[-1] == Path(path).stem)
                for path in REFERENCE_SUITES}
    check(all(n > 0 for n in per_file.values()),
          f"each reference suite ran gpu cases on the card ({per_file})")
    check(sum(per_file.values()) == len(outcomes),
          f"every case is counted under its file ({per_file}, {len(outcomes)})")
    check(any(n == REFERENCE_BLOCK_CASE and kind == "passed"
              for (_, n), kind in outcomes.items()),
          f"the engine's case through the block kernel passed ({REFERENCE_BLOCK_CASE})")
    check(wall < REFERENCE_SUITES_LIMIT_S,
          f"the reference suites ran within {REFERENCE_SUITES_LIMIT_S} s ({wall:.1f} s)")
    row = {"phase": "reference_suites", "seconds": wall,
           "command": " ".join(["python -m pytest", *argv[3:7], "-m gpu", *REFERENCE_SUITES]),
           "files": list(REFERENCE_SUITES), "passed": sum(per_file.values()),
           "passed_per_file": per_file, "summary": proc.stdout.strip().splitlines()[-1]}
    emit(row)
    return row


def wide_kernel_checks(topk) -> dict:
    """The exact kernels at RN50's d = 1024, bit for bit against their
    plain versions on exact-dot inputs: B1 (tree) and B2 (block), bf16,
    at 262,144 and 1,048,576 rows, at Q and every query bucket; B3 (SQ8)
    at N_SQ8_TAIL and RN50_STORE rows (the resnet phase's SQ8 store), at
    Q and every query bucket; and the tensor cores' accumulation error at
    d = 1024 against its model."""
    d = 1024
    gen = torch.Generator(device="cuda").manual_seed(SEED + 30)
    bit_equal_q = (Q,) + QUERY_BUCKETS
    sizes = (N_BLOCK, N_TREE)
    for n in sizes:
        emb, q_all = exact_inputs(n, torch.bfloat16, gen, d=d)
        tile = topk._tree_tile_rows(torch.bfloat16)
        levels = topk.default_levels(n)
        for name, cand, plain in (
                ("block", lambda qq: topk.block_candidates(emb, qq, levels),
                 lambda qq: topk.block_candidates_plain(emb, qq, levels)),
                ("tree", lambda qq: topk.tree_candidates(emb, qq, tile),
                 lambda qq: topk.tree_candidates_plain(emb, qq, tile))):
            for nq in bit_equal_q:
                got = cand(q_all[:nq])
                torch.cuda.synchronize()
                want = plain(q_all[:nq])
                check(all(torch.equal(a, b) for a, b in zip(got, want)),
                      f"{name} bf16 candidates at d = {d}, N = {n}, Q = {nq} equal the "
                      "plain version bit for bit")
                del got, want
        del emb, q_all
        torch.cuda.empty_cache()
    sq8_sizes = (N_SQ8_TAIL, RN50_STORE)
    for n in sq8_sizes:
        e8, scal2, q_all = exact_sq8_inputs(n, gen, d=d)
        for nq in bit_equal_q:
            q = q_all[:nq]
            qn = torch.linalg.norm(q, dim=1)
            got = topk.sq8_candidates(e8, scal2, q, qn, topk.SQ8_TILE_ROWS)
            torch.cuda.synchronize()
            want = topk.sq8_candidates_plain(e8, scal2, q, qn, topk.SQ8_TILE_ROWS)
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"sq8 candidates at d = {d}, N = {n}, Q = {nq} equal the plain "
                  "version bit for bit")
            del got, want
        del e8, scal2, q_all
    row = {"phase": "kernel_check_d1024", "d": d,
           "block_tree_bit_equal_plain_at_n": list(sizes),
           "block_tree_bit_equal_plain_at_q": list(bit_equal_q),
           "sq8_bit_equal_plain_at_n": list(sq8_sizes),
           "sq8_bit_equal_plain_at_q": list(bit_equal_q),
           **accumulation_check(topk, gen, d=d)}
    emit(row)
    torch.cuda.empty_cache()
    return row


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

    native_info: dict = {}

    def build_native():
        from evossearch_tpu_torch import native

        t0 = time.perf_counter()
        try:
            native_info.update(native.build())
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            jpeg, lib = native.probe()[0], native.pillow_libjpeg()
            native_info.update(error=repr(e), jpeglib_h=jpeg, route=native.route_of(jpeg, lib),
                               pillow_libjpeg=None if lib is None else str(lib))
        native_info["wall_s"] = time.perf_counter() - t0

    native_thread = threading.Thread(target=build_native)  # beside nvcc
    native_thread.start()
    t0 = time.perf_counter()
    libs = _build.build()
    build_s = time.perf_counter() - t0
    native_thread.join()
    native_phase(native_info, native_info.pop("wall_s"))
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
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        work = Path(tmp)
        launches, train_launches, train_mesh_launches = main_path(topk, search, work)
        launches["sq8_variant"] = variant_launches
        f32_launches = f32_search_path(topk, search)
        launches["tree_f32"], launches["block_f32"] = (f32_launches["tree_f32"],
                                                       f32_launches["block_f32"])
        ivf_phase(search, work)
        sharded_launches = sharded_phase(topk, search, work)
        rn50_launches = resnet_phase(topk, search, work)
    wide_kernel_checks(topk)
    bench_launches = bench_phase(topk)
    scripts_launches = scripts_phase(topk, smi)
    reference_suites_phase()
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
            # launches on the resnet phase's path (RN50, d = 1024) and on
            # the train phase's (none: training runs no kernel of these)
            "launches_rn50": rn50_launches[key],
            "launches_train": train_launches[key],
            # launches on the train_mesh phase's path (its exact_search)
            "launches_train_mesh": train_mesh_launches[key],
            # launches on the sharded phase's paths (parallel/ on one card)
            "launches_sharded": sharded_launches[key],
            # launches of the bench's phases (python -m evossearch_tpu_torch.bench
            # --phases search,encode_l14, a subprocess)
            "launches_bench": bench_launches[key],
            # launches the experiment scripts report (python -m
            # evossearch_tpu_torch.scripts.exp_*, subprocesses)
            "launches_scripts": scripts_launches[key],
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
