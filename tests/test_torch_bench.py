"""The port's bench (``evossearch_tpu_torch/bench.py``) and its two
validation scripts on the CPU, at tiny sizes.

Every phase runs end to end through ``run_bench`` with ``device="cpu"``,
its sizes shrunk by monkeypatch (as the JAX package's
``scripts/smoke_bench_phases.py`` shrinks ``bench.py``'s): a few
thousand rows, d = 128 (the SQ8 sweep and the engine's SQ8 tier take
widths in multiples of 128 only), tiny ViT and ResNet specs registered
in the port's spec table, and a few small JPEGs. Against the JAX package:
the FLOP counters equal the root ``bench.py``'s for every spec of both
packages' tables, and the headline's results equal the JAX package's
``best_exact_search_batch`` on the same inputs. Also: the stdout line,
``main()`` without a CUDA device, a corrupted result failing the oracle,
``--phases`` order, the budget, and the oracles themselves.
"""

from __future__ import annotations

import json
import os
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evossearch_tpu.core import CLIP_MODEL_SPECS as JAX_SPECS
from evossearch_tpu.index.search import best_exact_search_batch as jax_best
from evossearch_tpu_torch import bench
from evossearch_tpu_torch.core import CLIP_MODEL_SPECS
from evossearch_tpu_torch.core.constants import CLIPModelSpec, CLIPResNetSpec
from evossearch_tpu_torch.index import search as index_search
from evossearch_tpu_torch.scripts import serve_latency, val_sq8

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import bench as root_bench  # noqa: E402  (the JAX package's bench.py)

D = 128
TINY = CLIPModelSpec(
    name="bench-tiny", image_size=32, patch_size=16, vision_width=64,
    vision_layers=2, vision_heads=4, text_width=64, text_layers=2,
    text_heads=4, vocab_size=49408, context_length=16, embed_dim=D,
)
TINY_RN = CLIPResNetSpec(
    name="bench-tiny-rn", image_size=64, vision_width=16,
    vision_layers=(1, 1, 1, 1), vision_heads=8, text_width=64, text_layers=1,
    text_heads=4, vocab_size=49408, context_length=16, embed_dim=D,
)
SIZES = {
    "N_VECTORS": 3000, "DIM": D, "QUERY_BATCH": 8, "ITERS": 3, "MODEL": TINY.name,
    "SWEEP_ROWS": 5000, "SWEEP_ITERS": 2,
    "SQ8_ROWS": 16384, "SQ8_CHUNK": 4096, "SQ8_TILE": 512,
    "IVF_ROWS": 4000, "IVF_LISTS": 16, "IVF_ITERS": 3, "IVF_QUERIES": 8,
    "IVF3_ROWS": 4000, "IVF3_LISTS": 16, "IVF3_ITERS": 3, "IVF3_CHUNK": 1000,
    "IVF10_ROWS": 10_000, "HOST_IVF_ROWS": 3000, "HOST_IVF_LISTS": 12,
    "HOST_IVF_QUERIES": 4, "INDEX_IMAGES": 6, "PHOTO": (48, 64),
    # 2 x 4.9 MiB bf16 folders under 8 MiB: one fits, both do not; the tie
    # folder's 3.4 MiB of f32 over 2 MiB, its 0.9 MiB sidecar under
    "HBM_ROWS": 20_000, "HBM_CHUNK": 8192, "HBM_BUDGETS_MB": (8, 2),
    "SERVE_ROWS": 4096, "SERVE_CHUNK": 2048, "SERVE_THREADS": 3, "SERVE_PER_THREAD": 3,
    "TRAIN_BATCH": 4, "TRAIN_REPS": 2,
    "ENCODE": {"encode": (TINY.name, 2, 2), "encode_b16": (TINY.name, 2, 2),
               "encode_l14": (TINY.name, 2, 2), "encode_rn50": (TINY_RN.name, 2, 2)},
    "L14_CHECK_IMAGES": 2, "PIPELINE_BATCH": 4, "PIPELINE_REPS": 2,
    "ORACLE_ROWS": 1024,  # several oracle blocks at these sizes
}


@pytest.fixture()
def tiny(monkeypatch):
    for name, value in SIZES.items():
        monkeypatch.setattr(bench, name, value)
    monkeypatch.setitem(CLIP_MODEL_SPECS, TINY.name, TINY)
    monkeypatch.setitem(CLIP_MODEL_SPECS, TINY_RN.name, TINY_RN)
    for key in [k for k in os.environ if k.startswith("EVOSSEARCH_")]:
        monkeypatch.delenv(key)


def _headline(out: str) -> dict:
    lines = [line for line in out.splitlines() if line.strip()]
    assert len(lines) == 1, lines  # stdout holds the headline and nothing else
    return json.loads(lines[0])


# -- against the root bench.py -------------------------------------------

SPEC_CASES = [("port", name) for name in CLIP_MODEL_SPECS] + [
    ("jax", name) for name in JAX_SPECS]


@pytest.mark.parametrize("table,name", SPEC_CASES, ids=[f"{t}-{n}" for t, n in SPEC_CASES])
def test_flops_equal_root_bench(table, name):
    spec = (CLIP_MODEL_SPECS if table == "port" else JAX_SPECS)[name]
    if getattr(spec, "family", "vit") == "resnet":
        assert bench._resnet_fwd_flops(spec) == root_bench._resnet_fwd_flops(spec)
    else:
        assert bench._vit_fwd_flops(spec) == root_bench._vit_fwd_flops(spec)
    assert bench.image_fwd_flops(spec) > 0


def test_headline_equals_jax_package(tiny):
    """The headline's batch at a tiny size (the dense path on the CPU in
    both packages) against the JAX package's best_exact_search_batch on
    the same numpy inputs: ids equal, scores within 1e-5 (float32
    summation order)."""
    run = bench.Run("cpu")
    got = bench.bench_search(run)
    assert not run.failures
    emb = bench.unit_rows(bench.N_VECTORS, D, run.generator(0), "cpu").numpy()
    queries = bench.unit_rows(bench.QUERY_BATCH, D, run.generator(1), "cpu").numpy()
    s, i = jax_best(jnp.asarray(emb), jnp.asarray(queries), bench.K)
    np.testing.assert_array_equal(got["ids"], np.asarray(i))
    np.testing.assert_allclose(got["scores"], np.asarray(s), rtol=0, atol=1e-5)


# -- the run --------------------------------------------------------------


@pytest.mark.parametrize("name", list(bench.PHASES))
def test_phase_runs_on_cpu(name, tiny, capsys):
    assert bench.run_bench([name], "cpu") == 0
    out, err = capsys.readouterr()
    assert "FAILED" not in err
    phase = [json.loads(line[6:]) for line in err.splitlines() if line.startswith("phase {")]
    assert [p["name"] for p in phase] == [name] and phase[0]["ok"]
    # the CPU runs the kernels' plain versions: no launch is counted
    assert not any(phase[0]["launches"].values())
    assert ("check " in err) or name in ("encode", "encode_b16", "encode_rn50")
    if name == "search":
        line = _headline(out)
        assert set(line) == {"metric", "value", "unit", "device"}
        assert line["metric"] == "exact_top48_per_query_ms_at_1M_vectors_batch48"
        assert line["unit"] == "ms" and line["value"] > 0
        assert line["device"] == {"kind": "cpu"}
    else:
        assert out == ""


def test_sq8_phase_certifies_and_matches(tiny):
    """At the tiny size most queries certify (512-row tiles), and every
    certified one equals the dequantized oracle."""
    run = bench.Run("cpu")
    bench.bench_sq8(run)
    assert not run.failures
    line = next(x for x in run.lines if "certified" in x)
    certified = int(line.split("certified ")[1].split("/")[0])
    assert certified >= bench.QUERY_BATCH // 2, line
    assert f"equal to the oracle {certified}" in line


def test_corrupted_result_fails_the_oracle(tiny, monkeypatch, capsys):
    real = index_search.best_exact_search_batch

    def corrupted(emb, queries, k):
        s, i = real(emb, queries, k)
        return s, (i + 1) % emb.shape[0]

    monkeypatch.setattr(index_search, "best_exact_search_batch", corrupted)
    assert bench.run_bench(["search"], "cpu") == 1
    out, err = capsys.readouterr()
    assert "check search_oracle FAILED" in err
    assert _headline(out)["metric"].startswith("exact_top48")  # still printed


def test_corrupted_scores_fail_the_oracle(tiny):
    run = bench.Run("cpu")
    emb = bench.unit_rows(3000, D, run.generator(0), "cpu")
    q = bench.unit_rows(4, D, run.generator(1), "cpu")
    s, i = index_search.exact_search_batch(emb, q, 48)
    unit = bench.err_unit(torch.float32, D)
    assert bench.agreement(s, i, emb, q, unit)["ok"]
    bad = s.copy()
    bad[2, 7] += 1e-3  # far past the f32 bound (~6e-5 * sum|x*q|)
    verdict = bench.agreement(bad, i, emb, q, unit)
    assert not verdict["ok"] and verdict["matching"] == 3
    # a far row at the last rank (whether or not that rank is clear of a
    # near-tie), and a repeated row
    far = int(torch.argmin(emb @ q[1]))
    for qi, rank, row in ((1, -1, far), (3, 1, int(i[3, 0]))):
        bad_i = i.copy()
        bad_i[qi, rank] = row
        verdict = bench.agreement(s, bad_i, emb, q, unit)
        assert not verdict["ok"] and not verdict["rows_agree"] and verdict["matching"] == 3


def test_main_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    called = []
    monkeypatch.setattr(bench, "run_bench", lambda *a: called.append(a))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--phases", "search"])
    assert called == []


def test_phases_keep_main_order(monkeypatch, capsys):
    assert bench.select_phases(None) == list(bench.PHASES)
    assert len(bench.PHASES) == 14
    assert bench.select_phases("search_10m,encode,search") == ["search", "encode", "search_10m"]
    with pytest.raises(ValueError, match="unknown phases"):
        bench.select_phases("search,nope")
    with pytest.raises(SystemExit):
        bench.main(["--phases", "nope"])
    ran = []
    fake = {name: (lambda run, name=name: ran.append(name)) for name in bench.PHASES}
    monkeypatch.setattr(bench, "PHASES", fake)
    assert bench.run_bench(bench.select_phases("hbm,ivf,sq8"), "cpu") == 0
    assert ran == ["sq8", "ivf", "hbm"]


def test_failed_phase_fails_the_run_after_the_rest(monkeypatch, capsys):
    ran = []

    def boom(run):
        raise RuntimeError("boom")

    def over(run):
        run.step("a step")  # the budget is 0 s: over it at the first step

    fake = {"a": boom, "b": over, "c": lambda run: ran.append("c")}
    monkeypatch.setattr(bench, "PHASES", fake)
    monkeypatch.setitem(bench.BUDGETS_S, "b", 0)
    assert bench.run_bench(["a", "b", "c"], "cpu") == 1
    err = capsys.readouterr().err
    assert ran == ["c"]
    assert "[a] FAILED" in err and "[b] FAILED" in err
    assert "failures: ['phase a', 'phase b']" in err


@pytest.mark.parametrize("n,tail", [(5, None), (19, None), (20, None), (21, "p52"),
                                    (40, "p75"), (320, "p96")])
def test_timing_line(n, tail):
    """The median and sample count; from 21 samples the highest whole
    percentile with at least ten samples above it (at 20, the median)."""
    samples = np.arange(n, dtype=np.float64)
    line = bench.timing(samples)
    assert line.startswith(f"p50 {np.percentile(samples, 50):.4f} ms (n={n})")
    if tail is None:
        assert line.count(" p") == 0
    else:
        p = int(tail[1:])
        assert line.endswith(f"{tail} {np.percentile(samples, p):.4f} ms")
        assert (samples > np.percentile(samples, p)).sum() >= 10


# -- the oracles ----------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_oracle_is_the_stable_float64_ranking(dtype, monkeypatch):
    """oracle_topk over blocks equals a numpy float64 lexsort of the whole
    matrix, ties (duplicated rows) by the lower row."""
    monkeypatch.setattr(bench, "ORACLE_ROWS", 700)
    gen = torch.Generator().manual_seed(3)
    emb = bench.unit_rows(2500, D, gen, "cpu", dtype=dtype)
    emb[1800:1900] = emb[5]  # a plateau across blocks
    q = torch.cat([emb[5:6].float(), torch.randn(3, D, generator=gen)])
    o_s, o_i = bench.oracle_topk(emb, q, 48)
    full = q.double().numpy() @ emb.double().numpy().T
    for r in range(q.shape[0]):
        order = np.lexsort((np.arange(full.shape[1]), -full[r]))[:49]
        np.testing.assert_array_equal(o_i[r], order)
        np.testing.assert_array_equal(o_s[r], full[r][order])


def test_dequantized_oracle_and_rerank_agree(monkeypatch):
    """The SQ8 oracle's sweep and the rerank's gather give equal float64
    scores (exact sums), and equal a numpy float64 dequantized ranking."""
    monkeypatch.setattr(bench, "DIM", D)
    monkeypatch.setattr(bench, "SQ8_TILE", 512)
    monkeypatch.setattr(bench, "ORACLE_ROWS", 3000)
    e8, scal2 = bench.sq8_corpus(8192, 2048, 5, "cpu", normalize=True)
    q = bench.unit_rows(6, D, torch.Generator().manual_seed(9), "cpu")
    qb = bench.bf16_queries(q)
    assert bench.exactly_summable(qb)
    o_s, o_i = bench.sq8_oracle(e8, scal2, qb, 48)
    deq = e8.double().numpy() * scal2[0].double().numpy()[:, None]
    full = qb.double().numpy() @ deq.T
    for r in range(6):
        order = np.lexsort((np.arange(8192), -full[r]))[:48]
        np.testing.assert_array_equal(o_i[r], order)
    s, i, cert = bench.sq8_certified(e8, scal2, q, 512, 48)
    verdict = bench.sq8_verdict(s, i, cert, o_s, o_i)
    assert verdict["ok"] and verdict["certified"] >= 3
    assert verdict["matching"] == verdict["certified"]


def test_chunks_are_made_again_alone():
    """A chunk of a corpus made chunk by chunk is the same when made
    again by itself (its generator is seeded by (seed, chunk))."""
    a = torch.randn(64, 8, generator=bench.chunk_generator(4, 3, "cpu"))
    b = torch.randn(64, 8, generator=bench.chunk_generator(4, 3, "cpu"))
    c = torch.randn(64, 8, generator=bench.chunk_generator(4, 2, "cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c)


# -- the two validation scripts ------------------------------------------


def test_val_sq8_on_cpu(tiny):
    rows = val_sq8.phase_a("cpu", rows=(8192,))
    assert [r["phase"] for r in rows] == ["A"]
    assert rows[0]["ok"] and rows[0]["matching"] == val_sq8.Q
    assert 0 <= rows[0]["certified"] <= val_sq8.Q
    rows = val_sq8.phase_b("cpu", n=16384, fetches=(512, 128), chunk=4096)
    assert [r["fetch"] for r in rows] == [512, 128]
    assert all(r["ok"] and r["matching"] == r["certified"] for r in rows)
    assert rows[0]["certified"] > 0


def test_serve_latency_on_cpu(tiny):
    rows = serve_latency.measure("cpu", n=4096, reps=3, model=TINY.name)
    assert [r["measure"] for r in rows] == [
        "search_text_cache_miss", "search_text_cache_hit", "search_embedding"]
    assert all(r["ok"] and r["n"] == 3 and len(r["ms"]) == 3 for r in rows)


def test_scripts_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for script in (serve_latency, val_sq8):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            script.main()
