"""The port against tests/test_topk_pallas.py: the fused top-k kernels
against the numpy oracle, through ``ops.topk``'s plain versions on the
CPU (the JAX file runs the Pallas kernels in interpret mode; the CUDA
kernels are held bit for bit against these plain versions by
tests/test_torch_gpu.py and ``chip_smoke.py`` on the card).

Exact-recall property tests per SURVEY.md §4.2: random matrices,
adversarial ties, ragged tails, unnormalized queries (the kernel fuses
the L2 normalize). Harness only: ``ops.topk_pallas`` is ``ops.topk``,
arrays are torch tensors (bf16 as ``torch.bfloat16``) where the JAX file
has ``jnp`` arrays, and ``interpret=True`` is dropped (a CPU tensor runs
the plain version).
"""

import numpy as np
import pytest
import torch

from evossearch_tpu_torch.ops import fused_topk


def _t(x, dtype=torch.float32):
    return torch.as_tensor(np.asarray(x, np.float32)).to(dtype)


def _oracle(emb, q, k):
    qn = q / np.linalg.norm(q)
    scores = emb.astype(np.float64) @ qn.astype(np.float64)
    order = np.lexsort((np.arange(len(scores)), -scores))
    return scores[order[:k]].astype(np.float32), order[:k]


@pytest.mark.parametrize("n,d,k,block", [
    (1000, 64, 10, 256),
    (4096, 128, 48, 512),
    (777, 128, 48, 256),     # ragged tail, k*? > n/block
    (300, 128, 48, 256),     # two tiles, k close to tile size region
])
def test_matches_oracle(n, d, k, block):
    rng = np.random.default_rng(n)
    emb = rng.standard_normal((n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    q = rng.standard_normal(d).astype(np.float32) * 3.0  # unnormalized
    s, i = fused_topk(_t(emb), _t(q), k,
                      block_rows=block)
    os_, oi = _oracle(emb, q, k)
    np.testing.assert_array_equal(i.numpy(), oi)
    np.testing.assert_allclose(s.numpy(), os_, atol=1e-5)


def test_adversarial_ties():
    emb = np.tile(np.eye(8, dtype=np.float32)[0], (512, 1))
    q = np.eye(8, dtype=np.float32)[0]
    s, i = fused_topk(_t(emb), _t(q), 16, block_rows=128)
    np.testing.assert_array_equal(i.numpy(), np.arange(16))
    np.testing.assert_allclose(s.numpy(), 1.0, atol=1e-6)


def test_ascending_scores_worst_case():
    # every tile beats the previous threshold -> merge on every tile
    n, d = 2048, 32
    emb = np.zeros((n, d), np.float32)
    emb[:, 0] = np.linspace(0.0, 1.0, n)  # strictly ascending
    q = np.eye(d, dtype=np.float32)[0]
    s, i = fused_topk(_t(emb), _t(q), 8, block_rows=256)
    np.testing.assert_array_equal(i.numpy(), np.arange(n - 1, n - 9, -1))


def test_all_negative_scores():
    rng = np.random.default_rng(3)
    emb = -np.abs(rng.standard_normal((500, 32))).astype(np.float32)
    q = np.abs(rng.standard_normal(32)).astype(np.float32)
    s, i = fused_topk(_t(emb), _t(q), 10, block_rows=128)
    os_, oi = _oracle(emb, q, 10)
    np.testing.assert_array_equal(i.numpy(), oi)


def test_bfloat16_matrix():
    rng = np.random.default_rng(4)
    emb = rng.standard_normal((1024, 64)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    q = emb[100].copy()
    s, i = fused_topk(_t(emb, torch.bfloat16), _t(q), 5, block_rows=256)
    assert int(i.numpy()[0]) == 100


# -- batched one-pass kernel (round 2) --


def _oracle_batch(emb, queries, k):
    scores = np.asarray(queries, np.float32) @ np.asarray(emb, np.float32).T
    out_s, out_i = [], []
    for s in scores:
        order = np.lexsort((np.arange(len(s)), -s))[:k]
        out_s.append(s[order])
        out_i.append(order)
    return np.array(out_s), np.array(out_i, dtype=np.int64)


@pytest.mark.parametrize(
    "n,d,q,k",
    [(3000, 512, 5, 10), (2048, 256, 3, 7), (4100, 128, 8, 48),
     (50_000, 512, 48, 48), (513, 128, 1, 1)],
)
def test_batch_certified_rows_are_exact(n, d, q, k):
    from evossearch_tpu_torch.ops.topk import fused_topk_batch

    rng = np.random.default_rng(n + d)
    emb = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((q, d)).astype(np.float32)
    ok, s, i = fused_topk_batch(
        _t(emb), _t(queries), k
    )
    ok, s, i = ok.numpy(), s.numpy(), i.numpy()
    os_, oi_ = _oracle_batch(emb, queries, k)
    assert ok.shape == (q,)
    if ok.any():
        np.testing.assert_array_equal(i[ok], oi_[ok])
        np.testing.assert_allclose(s[ok], os_[ok], rtol=1e-5, atol=1e-4)
    if n >= 50_000:
        # Certification saturates with block count: P(4 of the top-k share
        # a 256-row block) ~ C(k,4)/L^3 — ~2.6% per query at 50K, 3e-6 at
        # the 1M BASELINE scale. Mid-scale may see a few flagged rows
        # (cheap fallback); most rows must certify.
        assert ok.mean() > 0.8


def test_batch_all_ties_fail_certification():
    # Adversarial mass ties: >3 top elements per 256-row block everywhere —
    # the kernel must FLAG this (ok=False), never silently return wrong rows.
    from evossearch_tpu_torch.ops.topk import fused_topk_batch

    emb = torch.ones((3000, 128), dtype=torch.float32)
    queries = torch.ones((4, 128), dtype=torch.float32)
    ok, _, _ = fused_topk_batch(emb, queries, 48)
    assert not ok.numpy().any()


def test_batch_duplicate_rows_tie_contract():
    from evossearch_tpu_torch.ops.topk import fused_topk_batch

    rng = np.random.default_rng(7)
    emb = rng.standard_normal((2000, 128)).astype(np.float32)
    emb[100] = emb[40]  # exact duplicate -> tie broken by lower index
    queries = rng.standard_normal((2, 128)).astype(np.float32)
    ok, s, i = fused_topk_batch(
        _t(emb), _t(queries), 60
    )
    ok, i = ok.numpy(), i.numpy()
    os_, oi_ = _oracle_batch(emb, queries, 60)
    np.testing.assert_array_equal(i[ok], oi_[ok])


def test_batch_bfloat16_certified():
    from evossearch_tpu_torch.ops.topk import fused_topk_batch

    rng = np.random.default_rng(3)
    emb = _t(rng.standard_normal((30_000, 512)), torch.bfloat16)
    queries = _t(rng.standard_normal((16, 512)))
    ok, s, i = fused_topk_batch(emb, queries, 48)
    ok, i = ok.numpy(), i.numpy()
    assert ok.mean() > 0.5  # mid-scale: some rows may fall back (see above)
    # oracle on the same bf16-rounded values: the kernel casts queries to
    # the embedding dtype exactly like the XLA path does
    os_, oi_ = _oracle_batch(
        emb.float().numpy(),
        queries.to(torch.bfloat16).float().numpy(), 48)
    np.testing.assert_array_equal(i[ok], oi_[ok])


def test_levels3_certified_rows_exact_and_depth_policy():
    # Depth-3 selection (top-2 per block + cert on the 3rd-best) is the
    # big-corpus kernel; at small n most rows fail certification for
    # k=48 (>=3 of the top-k share a block), so exactness of CERTIFIED
    # rows is validated with a small k where blocks are plentiful.
    from evossearch_tpu_torch.ops.topk import (
        _LEVELS3_MIN_ROWS, default_levels, fused_topk_batch,
    )

    assert default_levels(50_000) == 4
    assert default_levels(_LEVELS3_MIN_ROWS) == 3
    rng = np.random.default_rng(11)
    emb = rng.standard_normal((20_000, 128)).astype(np.float32)
    queries = rng.standard_normal((8, 128)).astype(np.float32)
    ok, s, i = fused_topk_batch(
        _t(emb), _t(queries), 4, levels=3
    )
    ok, s, i = ok.numpy(), s.numpy(), i.numpy()
    assert ok.mean() > 0.8  # C(4,3)/79^2 per query — cert nearly always
    os_, oi_ = _oracle_batch(emb, queries, 4)
    np.testing.assert_array_equal(i[ok], oi_[ok])
    np.testing.assert_allclose(s[ok], os_[ok], rtol=1e-5, atol=1e-4)


# -- halving-tree kernel (round 2) --


def test_tree_certified_rows_exact():
    from evossearch_tpu_torch.ops.topk import fused_topk_batch_tree

    rng = np.random.default_rng(0)
    n = 20_000  # 3 tiles at the f32 tile size, ragged tail
    emb = rng.standard_normal((n, 512)).astype(np.float32)
    queries = rng.standard_normal((9, 512)).astype(np.float32)
    os_, oi_ = _oracle_batch(emb, queries, 8)
    ok, s, i = fused_topk_batch_tree(
        _t(emb), _t(queries), 8
    )
    ok, s, i = ok.numpy(), s.numpy(), i.numpy()
    assert ok.mean() > 0.8  # k=8 over ~156 classes: cert nearly always
    np.testing.assert_array_equal(i[ok], oi_[ok])
    np.testing.assert_allclose(s[ok], os_[ok], rtol=1e-5, atol=1e-4)


def test_tree_duplicate_rows_tie_contract():
    from evossearch_tpu_torch.ops.topk import fused_topk_batch_tree

    rng = np.random.default_rng(5)
    emb = rng.standard_normal((20_000, 512)).astype(np.float32)
    emb[9000] = emb[200]  # exact duplicate spanning tree halves
    queries = emb[[200]].copy()
    ok, s, i = fused_topk_batch_tree(
        _t(emb), _t(queries), 4
    )
    ok, i = ok.numpy(), i.numpy()
    if ok[0]:
        assert i[0][0] == 200 and i[0][1] == 9000, i[0]


def test_tree_mass_ties_fail_certification():
    from evossearch_tpu_torch.ops.topk import fused_topk_batch_tree

    emb = np.zeros((20_000, 512), np.float32)
    emb[:, 0] = 1.0
    queries = np.ones((3, 512), np.float32)
    ok, _, _ = fused_topk_batch_tree(
        _t(emb), _t(queries), 48
    )
    assert not ok.numpy().any()


def test_tree_policy():
    from evossearch_tpu_torch.ops.topk import use_tree_kernel

    # big corpora take the tree; small/mid ones keep the block kernel
    assert use_tree_kernel(10_000_000, 48, torch.bfloat16)
    assert use_tree_kernel(1_000_000, 48, torch.float32)
    assert not use_tree_kernel(300_000, 48, torch.bfloat16)
    assert not use_tree_kernel(50_000, 48, torch.float32)
    # failure odds scale with C(k,3): large k needs more classes
    assert not use_tree_kernel(1_000_000, 128, torch.bfloat16)


def test_pallas_search_batch_fallback_covers_uncertified():
    # The public wrapper must return EXACT results even when certification
    # fails (all-ties) by routing failed rows to the XLA fallback.
    from evossearch_tpu_torch.index.search import pallas_search_batch

    emb = np.ones((3000, 128), np.float32)
    queries = np.ones((4, 128), np.float32)
    s, i = pallas_search_batch(torch.from_numpy(emb), queries, 10)
    np.testing.assert_array_equal(i, np.tile(np.arange(10), (4, 1)))


def test_pallas_search_batch_delegates_on_shape_mismatch():
    from evossearch_tpu_torch.index.search import pallas_search_batch

    rng = np.random.default_rng(1)
    emb = rng.standard_normal((1000, 96)).astype(np.float32)  # d % 128 != 0
    queries = rng.standard_normal((3, 96)).astype(np.float32)
    s, i = pallas_search_batch(torch.from_numpy(emb), queries, 5)
    os_, oi_ = _oracle_batch(emb, queries, 5)
    np.testing.assert_array_equal(i, oi_)
