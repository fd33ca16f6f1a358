"""The port's mesh-sharded IVF against the JAX package's, on the CPU: the
counterparts of tests/test_sharded_ivf.py on ``[cpu] * 8``, and
``ivf_mesh8.npz`` sidecars crossing between the packages both ways.

``build`` agrees with the JAX package's by statistics only (each package's
k-means, and the calibration's noise drawn from its own generator, as in
tests/test_torch_ivf.py); a sidecar one package built searches id for id
in the other, scores within 1e-6, and re-saves to the same bytes."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from evossearch_tpu.parallel import ShardedIVFIndex as RefShardedIVF
from evossearch_tpu.parallel import corpus_mesh as ref_mesh
from evossearch_tpu_torch.index.search import exact_search_batch
from evossearch_tpu_torch.index.store import bf16_bits
from evossearch_tpu_torch.parallel import ShardedIVFIndex, corpus_mesh

SCORE_ATOL = 1e-6


def _mesh(n=8):
    return corpus_mesh(devices=["cpu"] * n)


def _corpus(rng, n, d):
    m = rng.standard_normal((n, d)).astype(np.float32)
    return m / np.linalg.norm(m, axis=1, keepdims=True)


def _queries(rng, q, d):
    return _corpus(rng, q, d)


@pytest.fixture(scope="module")
def built():
    matrix = _corpus(np.random.default_rng(0), 4000, 64)
    idx = ShardedIVFIndex.build(matrix, mesh=_mesh(), nlist=32, bucket_factor=1.5,
                                seed=0)
    return matrix, idx


def test_full_probe_equals_exact(built):
    """nprobe = nlist scans every row (buckets and spill): the exact top-k
    under (score desc, id asc)."""
    matrix, idx = built
    assert len(idx.buckets) == 8 and idx.buckets[0].shape[:2] == (32, 24)
    queries = _queries(np.random.default_rng(1), 5, 64)
    es, ei = exact_search_batch(torch.from_numpy(matrix), queries, 10)
    s, i = idx.search_batch(queries, 10, nprobe=idx.nlist)
    np.testing.assert_array_equal(i, ei)
    np.testing.assert_allclose(s, es, rtol=0, atol=1e-5)


def test_tuned_recall(built):
    matrix, idx = built
    assert 1 <= idx.tuned_nprobe <= idx.nlist
    queries = _queries(np.random.default_rng(2), 16, 64)
    _, ei = exact_search_batch(torch.from_numpy(matrix), queries, 10)
    _, ai = idx.search_batch(queries, 10)  # auto nprobe
    hits = sum(len(set(ai[q].tolist()) & set(ei[q].tolist())) for q in range(16))
    assert hits / ei.size >= 0.9  # calibrated for 0.995; 0.9 = the JAX test's floor


def test_batch_beyond_chunk(built):
    """20 queries run in chunks of 8; a row's result equals the same query
    searched alone."""
    _, idx = built
    queries = np.random.default_rng(3).standard_normal((20, 64)).astype(np.float32)
    s_all, i_all = idx.search_batch(queries, 5, nprobe=4)
    s_one, i_one = idx.search_batch(queries[7:8], 5, nprobe=4)
    np.testing.assert_array_equal(i_all[7:8], i_one)
    np.testing.assert_allclose(s_all[7:8], s_one, rtol=0, atol=SCORE_ATOL)


def test_no_duplicate_ids_and_sorted(built):
    _, idx = built
    q = np.random.default_rng(4).standard_normal(64).astype(np.float32)
    s, i = idx.search(q, 20)
    assert len(set(i.tolist())) == len(i) and (i >= 0).all()
    for a in range(len(s) - 1):
        assert s[a] > s[a + 1] or (s[a] == s[a + 1] and i[a] < i[a + 1])


def test_adversarial_ties_lowest_ids():
    """All rows identical: every score ties, the merge keeps the lowest
    global ids."""
    matrix = np.tile(np.eye(8, dtype=np.float32)[0], (400, 1))
    idx = ShardedIVFIndex.build(matrix, mesh=_mesh(), nlist=4, seed=0,
                                tune_target=None)
    s, i = idx.search(np.eye(8, dtype=np.float32)[0], 10, nprobe=idx.nlist)
    np.testing.assert_array_equal(i, np.arange(10))
    np.testing.assert_allclose(s, 1.0, atol=1e-6)


def test_tiny_corpus_padding():
    """n < blocks and n < k: empty blocks, -1 padding dropped by search()."""
    matrix = _corpus(np.random.default_rng(5), 5, 16)
    idx = ShardedIVFIndex.build(matrix, mesh=_mesh(), nlist=2, seed=0,
                                tune_target=None)
    s, i = idx.search(matrix[0], 48, nprobe=idx.nlist)
    assert len(i) == 5 and len(set(i.tolist())) == 5
    assert i[0] == 0
    bs, bi = idx.search_batch(matrix[:1], 48, nprobe=idx.nlist)
    assert bi.shape == (1, 5) and sorted(bi[0].tolist()) == list(range(5))


def test_bf16_buckets():
    rng = np.random.default_rng(6)
    matrix = bf16_bits(_corpus(rng, 2000, 64))
    idx = ShardedIVFIndex.build(matrix, mesh=_mesh(), nlist=16, seed=0,
                                tune_target=None)
    assert idx.buckets[0].dtype == torch.bfloat16
    q = _queries(rng, 1, 64)[0]
    s, i = idx.search(q, 10, nprobe=idx.nlist)
    es, ei = exact_search_batch(torch.from_numpy(matrix).view(torch.bfloat16), q[None], 10)
    np.testing.assert_array_equal(i, ei[0])
    np.testing.assert_allclose(s, es[0], rtol=0, atol=SCORE_ATOL)


def test_save_load_roundtrip(built, tmp_path):
    _, idx = built
    path = tmp_path / "ivf_mesh8.npz"
    idx.save(path)
    loaded = ShardedIVFIndex.load(path, mesh=_mesh())
    assert loaded is not None
    assert (loaded.n, loaded.nlist, loaded.tuned_nprobe) == (idx.n, idx.nlist,
                                                            idx.tuned_nprobe)
    q = np.random.default_rng(7).standard_normal(64).astype(np.float32)
    s0, i0 = idx.search(q, 12)
    s1, i1 = loaded.search(q, 12)
    np.testing.assert_array_equal(i0, i1)
    np.testing.assert_array_equal(s0, s1)


def test_load_rejects_mesh_size_mismatch(built, tmp_path):
    _, idx = built
    path = tmp_path / "ivf_mesh8.npz"
    idx.save(path)
    assert ShardedIVFIndex.load(path, mesh=_mesh(4)) is None


def test_load_rejects_garbage(tmp_path):
    p = tmp_path / "bad.npz"
    p.write_bytes(b"not an npz")
    assert ShardedIVFIndex.load(p, mesh=_mesh()) is None


def _npz_arrays(path):
    with np.load(path, allow_pickle=False) as data:
        return {key: data[key] for key in data.files}


def _assert_same_arrays(a, b):
    assert list(a) == list(b)
    for key in a:
        assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape, key
        assert a[key].tobytes() == b[key].tobytes(), key


def _ivf_corpus(dtype):
    """A clustered corpus (tests/test_torch_ivf.py's photo-library shape),
    as each package holds it: f32, or bf16 (port: uint16 bits; JAX:
    ml_dtypes)."""
    rng = np.random.default_rng(20)
    centers = _corpus(rng, 40, 64)
    emb = centers[rng.integers(0, 40, 6000)] + 0.15 * rng.standard_normal((6000, 64))
    emb = (emb / np.linalg.norm(emb, axis=1, keepdims=True)).astype(np.float32)
    if dtype == "bf16":
        return bf16_bits(emb), emb.astype(ml_dtypes.bfloat16)
    return emb, emb


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_reference_sidecar_searches_alike(dtype, tmp_path):
    """An ivf_mesh8.npz the JAX package built, loaded by the port: the
    same ids at the auto, a small and the full nprobe, scores within 1e-6;
    the port re-saves it byte for byte."""
    port_rows, ref_rows = _ivf_corpus(dtype)
    ref = RefShardedIVF.build(ref_rows, mesh=ref_mesh(8), nlist=32, seed=0)
    path = tmp_path / "ivf_mesh8.npz"
    ref.save(path)
    port = ShardedIVFIndex.load(path, mesh=_mesh())
    assert port is not None and port.tuned_nprobe == ref.tuned_nprobe
    assert port.buckets[0].dtype == (torch.bfloat16 if dtype == "bf16" else torch.float32)
    queries = _queries(np.random.default_rng(21), 12, 64)
    for nprobe in (0, 4, 32):
        rs, ri = ref.search_batch(queries, 24, nprobe)
        ps, pi = port.search_batch(queries, 24, nprobe)
        assert pi.dtype == np.int64 and ps.dtype == np.float32
        np.testing.assert_array_equal(pi, ri)
        np.testing.assert_allclose(ps, rs, rtol=0, atol=SCORE_ATOL)
    port.save(tmp_path / "port_resaved.npz")
    _assert_same_arrays(_npz_arrays(path), _npz_arrays(tmp_path / "port_resaved.npz"))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_port_sidecar_searched_by_reference(dtype, tmp_path):
    """An ivf_mesh8.npz the port built, loaded by the JAX package: the same
    ids, scores within 1e-6, and the JAX package re-saves it byte for
    byte; the build matches the JAX package's by statistics (nlist, cap,
    the calibrated nprobe within a factor of 2)."""
    port_rows, ref_rows = _ivf_corpus(dtype)
    port = ShardedIVFIndex.build(port_rows, mesh=_mesh(), nlist=32, seed=0)
    path = tmp_path / "ivf_mesh8.npz"
    port.save(path)
    ref = RefShardedIVF.load(path, mesh=ref_mesh(8))
    assert ref is not None and ref.tuned_nprobe == port.tuned_nprobe
    assert (ref.buckets.dtype == jnp.bfloat16) == (dtype == "bf16")
    queries = _queries(np.random.default_rng(22), 12, 64)
    for nprobe in (0, 32):
        ps, pi = port.search_batch(queries, 24, nprobe)
        rs, ri = ref.search_batch(queries, 24, nprobe)
        np.testing.assert_array_equal(pi, ri)
        np.testing.assert_allclose(ps, rs, rtol=0, atol=SCORE_ATOL)
    ref.save(tmp_path / "ref_resaved.npz")
    _assert_same_arrays(_npz_arrays(path), _npz_arrays(tmp_path / "ref_resaved.npz"))
    built_ref = RefShardedIVF.build(ref_rows, mesh=ref_mesh(8), nlist=32, seed=0)
    assert built_ref.buckets.shape[1] == port.buckets[0].shape[1]
    assert 0.5 <= built_ref.tuned_nprobe / port.tuned_nprobe <= 2
