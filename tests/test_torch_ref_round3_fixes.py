"""The port against tests/test_round3_fixes.py, the round-3 fixes
(VERDICT.md round 2).

Covers: the uncertified-row fallback (weak #5) and the query-row bucket
ladder that the port's serving paths pad to (``engine.py``,
``parallel/sharded_sq8.py``). Harness only: the corpus and queries are
torch tensors where the JAX file has ``jnp`` arrays.

Two JAX tests have no counterpart, because they pin jit's recompilation,
which the port does not have: eager torch runs any row count without a
compile, so its fallback gathers exactly the failed rows.
- ``test_gather_query_rows_pads_with_first_row``: the JAX package's
  ``index/search.py:gather_query_rows`` pads a fallback's rows to a bucket
  so that jit reuses a program; the port has no such function
  (``index/search.py:_unpack_with_fallback`` indexes the failed rows).
- ``test_fallback_compiles_are_bucket_bounded``: counts the programs in
  ``_topk_batch``'s jit cache (``_cache_size``); the port's
  ``_topk_batch`` is a plain function with no cache.
"""

import numpy as np
import torch

from evossearch_tpu_torch.index.search import (
    _topk_batch,
    _unpack_with_fallback,
    query_row_bucket,
)


def test_query_row_bucket_ladder():
    assert query_row_bucket(1) == 1
    assert query_row_bucket(2) == 8
    assert query_row_bucket(8) == 8
    assert query_row_bucket(9) == 64
    assert query_row_bucket(64) == 64
    assert query_row_bucket(65) == 128
    assert query_row_bucket(128) == 128
    assert query_row_bucket(129) == 256
    assert query_row_bucket(300) == 512


def _packed_with_failures(emb, queries, k, fail_rows):
    """True packed result with `fail_rows` marked uncertified and their
    scores/indices garbled — the fallback must repair exactly those."""
    s, i = (x.numpy() for x in _topk_batch(
        torch.from_numpy(emb), torch.from_numpy(queries), k
    ))
    s, i = s.copy(), i.copy()
    ok = np.ones((len(queries), 1), np.float32)
    ok[fail_rows] = 0.0
    s[fail_rows] = -1.0
    i[fail_rows] = 0
    return np.concatenate([s, i.astype(np.float32), ok], axis=1), s, i


def test_fallback_repairs_only_uncertified_rows():
    rng = np.random.default_rng(1)
    emb = rng.standard_normal((500, 32)).astype(np.float32)
    queries = rng.standard_normal((10, 32)).astype(np.float32)
    k = 5
    packed, _, _ = _packed_with_failures(emb, queries, k, [2, 5, 9])
    s, i = _unpack_with_fallback(packed, torch.from_numpy(emb),
                                 torch.from_numpy(queries), k)
    es, ei = (x.numpy() for x in _topk_batch(
        torch.from_numpy(emb), torch.from_numpy(queries), k
    ))
    np.testing.assert_allclose(s, es, rtol=1e-6)
    np.testing.assert_array_equal(i, ei)


def test_fallback_matches_the_jax_package():
    """The repaired rows against the JAX package's ``_unpack_with_fallback``
    on the same packed input (its fallback is the oracle)."""
    import jax.numpy as jnp

    from evossearch_tpu.index.search import (
        _unpack_with_fallback as ref_unpack,
    )

    rng = np.random.default_rng(1)
    emb = rng.standard_normal((500, 32)).astype(np.float32)
    queries = rng.standard_normal((10, 32)).astype(np.float32)
    k = 5
    packed, _, _ = _packed_with_failures(emb, queries, k, [2, 5, 9])
    s, i = _unpack_with_fallback(packed.copy(), torch.from_numpy(emb),
                                 torch.from_numpy(queries), k)
    rs, ri = ref_unpack(packed.copy(), jnp.asarray(emb), jnp.asarray(queries), k)
    np.testing.assert_allclose(s, np.asarray(rs), rtol=1e-6)
    np.testing.assert_array_equal(i, np.asarray(ri))
