"""E1, the SQ8 sweep's time-split variants: the port's plain versions
against the JAX package's own kernels in interpret mode.

``bf16_struct`` is the SQ8 bound over a bf16 corpus, which is what the
reference's ``sq8_candidates`` computes when handed a bf16 corpus (its
``astype(bfloat16)`` is then the identity); ``int8_noscale`` is the raw
dot of an int8 corpus, which is the reference's tree kernel on the corpus
widened to bf16 (exact for int8). Exact-dot inputs must agree bit for
bit; unit rows within the stated summation-order tolerance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evossearch_tpu.ops import topk_pallas as ref_topk
from evossearch_tpu_torch.index.sq8 import quantize_rows
from evossearch_tpu_torch.ops import topk

D = 128
TILE = 512
N = 3 * TILE + 77  # three tiles and a ragged tail


def _exact_inputs(seed, q):
    """int8-valued rows (as int8, and as bf16, where they are exact),
    power-of-two scales, queries of small integers over 16: every dot is
    exact in f32, and duplicate rows tie for real."""
    rng = np.random.default_rng(seed)
    e8 = rng.integers(-127, 128, (N, D)).astype(np.int8)
    e8[5::89] = e8[2]  # equal figures inside one class
    scale = (2.0 ** -rng.integers(5, 10, N)).astype(np.float32)
    radd = (rng.random(N) * 1e-2).astype(np.float32)
    queries = (rng.integers(-4, 5, (q, D)) / 16).astype(np.float32)
    qn = np.linalg.norm(queries, axis=1).astype(np.float32)
    return e8, np.stack([scale, radd]), queries, qn


def _padded(queries, qn):
    qp = np.zeros((ref_topk.LANES, D), np.float32)
    qp[: len(queries)] = queries
    qnp = np.zeros((ref_topk.LANES, 1), np.float32)
    qnp[: len(queries), 0] = qn
    return jnp.asarray(qp), jnp.asarray(qnp)


def _reference(variant, e8_or_rows, scal2, queries, qn):
    """The JAX package's kernel for the variant, in interpret mode, cut to
    the real queries. ``e8_or_rows``: f32 rows for bf16_struct (exactly
    representable in bf16), int8 rows for int8_noscale."""
    qp, qnp = _padded(queries, qn)
    corpus = jnp.asarray(e8_or_rows).astype(jnp.bfloat16)
    if variant == "bf16_struct":
        out = ref_topk.sq8_candidates(corpus, jnp.asarray(scal2), qp, qnp, TILE,
                                      interpret=True)
    else:
        out = ref_topk._tree_candidates(corpus, qp, TILE, True)
    return [np.asarray(a)[: len(queries)] for a in out]


def _port(variant, e8_or_rows, scal2, queries, qn):
    corpus = torch.from_numpy(np.asarray(e8_or_rows))
    if variant == "bf16_struct":
        corpus = corpus.to(torch.float32).to(torch.bfloat16)
    return topk.sq8_variant_candidates(
        corpus, torch.from_numpy(scal2), torch.from_numpy(queries),
        torch.from_numpy(qn), variant, TILE)


@pytest.mark.parametrize("variant", sorted(topk.SQ8_VARIANTS))
@pytest.mark.parametrize("q", [1, 8])
def test_variant_equals_pallas_exact_inputs(variant, q):
    e8, scal2, queries, qn = _exact_inputs(10 + q, q)
    rows = e8.astype(np.float32) if variant == "bf16_struct" else e8
    want = _reference(variant, rows, scal2, queries, qn)
    before = dict(topk.LAUNCHES)
    got = _port(variant, rows, scal2, queries, qn)
    assert topk.LAUNCHES == before  # a CPU tensor takes the plain version
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)


def test_bf16_struct_is_the_sq8_sweep_on_bf16_rows():
    """Same figures as the int8 sweep where the corpus holds the same
    values: the two differ only in the corpus dtype."""
    e8, scal2, queries, qn = _exact_inputs(3, 5)
    args = (torch.from_numpy(scal2), torch.from_numpy(queries), torch.from_numpy(qn))
    int8 = topk.sq8_candidates(torch.from_numpy(e8), *args, TILE)
    bf16 = topk.sq8_variant_candidates(
        torch.from_numpy(e8).to(torch.bfloat16), *args, "bf16_struct", TILE)
    for a, b in zip(int8, bf16):
        assert torch.equal(a, b)


def test_variants_on_unit_rows_near_pallas():
    """Unit rows quantized by the tier's own rule. The dots are f32 sums
    in another order than XLA's: each variant's figures agree within the
    serial summation bound 2 * d * 2^-24 * max||row|| * max||q|| of its
    dot (bf16_struct's scales are below 1/127 and its figures below 1, so
    the same bound covers its three roundings), and the rows agree
    wherever the figures are not near-tied."""
    rng = np.random.default_rng(7)
    rows = rng.standard_normal((N, D)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    rows_bf = torch.from_numpy(rows).to(torch.bfloat16).to(torch.float32).numpy()
    e8, scal2 = quantize_rows(rows_bf)
    queries = rng.standard_normal((6, D)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    qn = np.linalg.norm(queries, axis=1).astype(np.float32)
    qmax = float(np.linalg.norm(queries, axis=1).max())
    for variant, corpus in (("bf16_struct", rows_bf), ("int8_noscale", e8)):
        rmax = float(np.linalg.norm(corpus.astype(np.float32), axis=1).max())
        tol = 2 * D * 2.0**-24 * rmax * qmax
        want = _reference(variant, corpus, scal2, queries, qn)
        got = _port(variant, corpus, scal2, queries, qn)
        np.testing.assert_allclose(got[0].numpy(), want[0], rtol=0, atol=tol)
        np.testing.assert_allclose(got[2].numpy(), want[2], rtol=0, atol=tol)
        assert (got[1].numpy() == want[1]).mean() > 0.999


def test_variant_wrapper_checks():
    e8 = torch.zeros((1000, 128), dtype=torch.int8)
    e16 = torch.zeros((1000, 128), dtype=torch.bfloat16)
    scal2 = torch.ones((2, 1000))
    q = torch.zeros((2, 128))
    qn = torch.zeros(2)
    # int8_noscale reads neither scal2 nor the norms
    out = topk.sq8_variant_candidates(e8, None, q, None, "int8_noscale", 512)
    assert [tuple(t.shape) for t in out] == [(2, 512), (2, 512), (2, 256)]
    for bad in (
        lambda: topk.sq8_variant_candidates(e8, scal2, q, qn, "bf16", 512),
        lambda: topk.sq8_variant_candidates(e8, scal2, q, qn, "bf16_struct", 512),
        lambda: topk.sq8_variant_candidates(e16, scal2, q, qn, "int8_noscale", 512),
        lambda: topk.sq8_variant_candidates(e16, None, q, qn, "bf16_struct", 512),
        lambda: topk.sq8_variant_candidates(e16, scal2[:, :10], q, qn, "bf16_struct", 512),
        lambda: topk.sq8_variant_candidates(e16, scal2, q, torch.zeros(3), "bf16_struct", 512),
        lambda: topk.sq8_variant_candidates(e16[:, :100].contiguous(), scal2,
                                            q[:, :100], qn, "bf16_struct", 512),
        lambda: topk.sq8_variant_candidates(e8, None, torch.zeros((129, 128)), None,
                                            "int8_noscale", 512),
        lambda: topk.sq8_variant_candidates(e8, None, q, None, "int8_noscale", 768),
        lambda: topk.sq8_variant_candidates(e8.t(), None, q, None, "int8_noscale", 512),
    ):
        with pytest.raises(ValueError):
            bad()
