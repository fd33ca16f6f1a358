"""The port's single-query top-k (``ops.fused_topk``, kernel B4; its plain
version here on the CPU) against the JAX package's Pallas ``fused_topk``
in interpret mode, on the cases of tests/test_topk_pallas.py:33-75 and on
exact-dot inputs. The CUDA kernel is held against the plain version in
tests/test_torch_gpu.py and chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evossearch_tpu.ops import fused_topk as ref_fused_topk
from evossearch_tpu_torch.ops import fused_topk, topk

DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
# Scores on unit rows: the query's norm (XLA's rsqrt against a correctly
# rounded one) and the f32 sums run in other orders; observed <= 9e-8.
SCORE_ATOL = 1e-6


def _both(emb, q, k, block, dtype):
    tdt, jdt = DTYPES[dtype]
    s_r, i_r = ref_fused_topk(jnp.asarray(emb, jdt), jnp.asarray(q), k,
                              block_rows=block, interpret=True)
    s, i = fused_topk(torch.from_numpy(emb).to(tdt), torch.from_numpy(q), k,
                      block_rows=max(block, 128))
    assert s.dtype == torch.float32 and i.dtype == torch.int64 and s.shape == (k,)
    return s.numpy(), i.numpy(), np.asarray(s_r), np.asarray(i_r)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n,d,k,block", [
    (1000, 64, 10, 256),
    (4096, 128, 48, 512),
    (777, 128, 48, 256),     # ragged tail
    (300, 128, 48, 256),     # two tiles
])
def test_matches_pallas(n, d, k, block, dtype):
    rng = np.random.default_rng(n)
    emb = rng.standard_normal((n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    q = rng.standard_normal(d).astype(np.float32) * 3.0  # unnormalized
    s, i, s_r, i_r = _both(emb, q, k, block, dtype)
    np.testing.assert_array_equal(i, i_r)
    np.testing.assert_allclose(s, s_r, rtol=0, atol=SCORE_ATOL)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("k", [48, 128])
def test_exact_inputs_bit_equal(dtype, k):
    """Rows of small integers over 16 and a query of 256 entries +-1/16
    (norm exactly 1): every score is exact and ties are real."""
    rng = np.random.default_rng(k)
    n, d = 3000, 512
    emb = (rng.integers(-4, 5, (n, d)) / 16).astype(np.float32)
    q = np.zeros(d, np.float32)
    q[rng.choice(d, 256, replace=False)] = rng.choice([-1.0, 1.0], 256) / 16
    s, i, s_r, i_r = _both(emb, q, k, 512, dtype)
    np.testing.assert_array_equal(i, i_r)
    np.testing.assert_array_equal(s, s_r)


def test_adversarial_ties():
    emb = np.tile(np.eye(8, dtype=np.float32)[0], (512, 1))
    q = np.eye(8, dtype=np.float32)[0]
    s, i, s_r, i_r = _both(emb, q, 16, 128, "f32")
    np.testing.assert_array_equal(i, np.arange(16))
    np.testing.assert_array_equal(i, i_r)
    np.testing.assert_array_equal(s, s_r)


def test_ascending_scores_worst_case():
    n, d = 2048, 32
    emb = np.zeros((n, d), np.float32)
    emb[:, 0] = np.linspace(0.0, 1.0, n)
    q = np.eye(d, dtype=np.float32)[0]
    s, i, s_r, i_r = _both(emb, q, 8, 256, "f32")
    np.testing.assert_array_equal(i, np.arange(n - 1, n - 9, -1))
    np.testing.assert_array_equal(i, i_r)


def test_all_negative_scores():
    rng = np.random.default_rng(3)
    emb = -np.abs(rng.standard_normal((500, 32))).astype(np.float32)
    q = np.abs(rng.standard_normal(32)).astype(np.float32)
    s, i, s_r, i_r = _both(emb, q, 10, 128, "f32")
    np.testing.assert_array_equal(i, i_r)
    np.testing.assert_allclose(s, s_r, rtol=0, atol=SCORE_ATOL)


def test_bfloat16_matrix():
    rng = np.random.default_rng(4)
    emb = rng.standard_normal((1024, 64)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    s, i, s_r, i_r = _both(emb, emb[100].copy(), 5, 256, "bf16")
    assert i[0] == 100
    np.testing.assert_array_equal(i, i_r)


def test_fewer_rows_than_k_pad_like_the_reference():
    rng = np.random.default_rng(5)
    emb = rng.standard_normal((40, 64)).astype(np.float32)
    s, i, s_r, i_r = _both(emb, emb[3].copy(), 48, 128, "f32")
    np.testing.assert_array_equal(i, i_r)
    np.testing.assert_array_equal(s[40:], s_r[40:])
    assert (i[40:] == -1).all() and (s[40:] == topk.NEG_INF).all()


def test_wrapper_checks_and_counts_no_cpu_launch():
    emb = torch.zeros((1000, 64))
    before = dict(topk.LAUNCHES)
    fused_topk(emb, torch.ones(64), 5)
    assert topk.LAUNCHES == before
    for bad in (
        lambda: fused_topk(emb, torch.ones(64), 129),
        lambda: fused_topk(emb, torch.ones(64), 0),
        lambda: fused_topk(emb, torch.ones(32), 5),
        lambda: fused_topk(emb.half(), torch.ones(64), 5),
        lambda: fused_topk(emb, torch.ones(64), 5, block_rows=1000),
        lambda: fused_topk(torch.zeros((100, 12)), torch.ones(12), 5),
    ):
        with pytest.raises(ValueError):
            bad()
