"""The port's IVF index against the JAX package's, on the CPU.

Searches are held against the reference on sidecars that one package
built and the other loaded (the same centroids and buckets, so the same
probes): the same ids, scores within SCORE_ATOL, f32 and bf16 buckets.
``build`` itself is held only by statistics (centroids close, assignments
equal on at least 99.9% of rows): the two packages sum in different
orders, so a near-tie may assign a row to another list. Then the engine's
routes under EVOSSEARCH_INDEX_KIND=ivf: the persisted sidecar, its reload
and staleness rule, the over-budget folder's host probe, and no fused
text path."""

import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from evossearch_tpu.index import ivf as ref_ivf
from evossearch_tpu.index.ivf import IVFIndex as RefIVF
from evossearch_tpu_torch.core import Config
from evossearch_tpu_torch.core.constants import CLIPModelSpec
from evossearch_tpu_torch.engine import SearchEngine, _canon
from evossearch_tpu_torch.index import ivf
from evossearch_tpu_torch.index.ivf import NEG_INF, IVFIndex
from evossearch_tpu_torch.index.search import exact_search_batch, exact_search_host
from evossearch_tpu_torch.index.store import IndexWriter

SCORE_ATOL = 1e-6
NLIST = 128
D = 64


def _clustered_corpus(n=20_000, d=D, n_clusters=100, seed=0):
    """tests/test_ivf.py's photo-library-like corpus: clustered on the
    sphere."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, d))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    assign = rng.integers(0, n_clusters, n)
    emb = centers[assign] + 0.15 * rng.standard_normal((n, d))
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    return emb.astype(np.float32)


def _queries(emb, n=16, seed=1, noise=0.1):
    rng = np.random.default_rng(seed)
    q = emb[rng.integers(0, len(emb), n)] + noise * rng.standard_normal(
        (n, emb.shape[1])).astype(np.float32)
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def corpus():
    return _clustered_corpus()


@pytest.fixture(scope="module")
def ref_sidecars(corpus, tmp_path_factory):
    """Sidecars the JAX package built, f32 and bf16 buckets."""
    root = tmp_path_factory.mktemp("ref_ivf")
    out = {}
    for name, emb in (("f32", corpus), ("bf16", corpus.astype(ml_dtypes.bfloat16))):
        built = RefIVF.build(emb, nlist=NLIST, iters=8, pre_normalized=True)
        built.save(root / f"{name}.npz")
        out[name] = (built, root / f"{name}.npz")
    return out


@pytest.fixture(scope="module")
def port_ivf(corpus):
    return IVFIndex.build(corpus, nlist=NLIST, iters=8, device="cpu")


def _npz_arrays(path):
    with np.load(path, allow_pickle=False) as data:
        return {key: data[key] for key in data.files}


def _assert_same_arrays(a, b):
    assert list(a) == list(b)
    for key in a:
        assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape, key
        assert a[key].tobytes() == b[key].tobytes(), key


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_reference_sidecar_searches_alike(dtype, corpus, ref_sidecars):
    """A sidecar the JAX package built, loaded by the port: the same ids
    as the JAX package's search_batch at the auto, a small and the full
    nprobe, scores within SCORE_ATOL."""
    ref, path = ref_sidecars[dtype]
    port = IVFIndex.load(path, device="cpu")
    assert port is not None and port.tuned_nprobe == ref.tuned_nprobe
    assert port.buckets.dtype == (torch.bfloat16 if dtype == "bf16" else torch.float32)
    q = _queries(corpus)
    for nprobe in (0, 8, NLIST):
        rs, ri = ref.search_batch(q, 48, nprobe)
        ps, pi = port.search_batch(q, 48, nprobe)
        assert pi.dtype == np.int64 and ps.dtype == np.float32
        np.testing.assert_array_equal(pi, ri)
        np.testing.assert_allclose(ps, rs, rtol=0, atol=SCORE_ATOL)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_sidecars_cross_load_both_ways(dtype, corpus, ref_sidecars, tmp_path):
    """The port's sidecar loads in the JAX package with the same results,
    and each package re-saves the other's sidecar with the same arrays,
    dtypes and key order (bf16 as uint16 bits, meta int64)."""
    emb = torch.from_numpy(corpus)
    if dtype == "bf16":
        emb = emb.to(torch.bfloat16)
    port = IVFIndex.build(emb, nlist=NLIST, iters=8, pre_normalized=True)
    port.save(tmp_path / "port.npz")
    ref = RefIVF.load(tmp_path / "port.npz")
    assert ref is not None and ref.n == port.n and ref.nlist == NLIST
    assert (ref.buckets.dtype == jnp.bfloat16) == (dtype == "bf16")
    q = _queries(corpus, seed=5)
    ps, pi = port.search_batch(q, 48)
    rs, ri = ref.search_batch(q, 48)
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_allclose(ps, rs, rtol=0, atol=SCORE_ATOL)
    ref.save(tmp_path / "ref_resaved.npz")
    _assert_same_arrays(_npz_arrays(tmp_path / "port.npz"),
                        _npz_arrays(tmp_path / "ref_resaved.npz"))
    _, ref_path = ref_sidecars[dtype]
    IVFIndex.load(ref_path, device="cpu").save(tmp_path / "port_resaved.npz")
    _assert_same_arrays(_npz_arrays(ref_path), _npz_arrays(tmp_path / "port_resaved.npz"))


def test_load_corrupt_or_missing_returns_none(tmp_path):
    (tmp_path / "ivf.npz").write_bytes(b"garbage")
    assert IVFIndex.load(tmp_path / "ivf.npz", device="cpu") is None
    assert IVFIndex.load(tmp_path / "absent.npz", host=True) is None


def test_build_agrees_with_reference_statistically(corpus, ref_sidecars, port_ivf):
    """Same seed, same initial rows (the numpy draw), the same Lloyd
    iterations: the centroids agree to float noise and the assignments on
    at least 99.9% of rows."""
    ref, _ = ref_sidecars["f32"]
    ref_cent = np.asarray(ref.centroids)
    assert np.abs(port_ivf.centroids.numpy() - ref_cent).max() < 1e-4
    a_port = ivf._assign(torch.from_numpy(corpus), port_ivf.centroids).numpy()
    a_ref = np.asarray(ref_ivf._assign(jnp.asarray(corpus), jnp.asarray(ref_cent)))
    assert (a_port == a_ref).mean() >= 0.999
    assert port_ivf.buckets.shape == ref.buckets.shape
    assert port_ivf.spill.shape[0] == pytest.approx(ref.spill.shape[0], abs=20)
    # calibration lands near the reference's (its noise is another draw)
    assert 0 < port_ivf.tuned_nprobe < NLIST // 4
    assert abs(port_ivf.tuned_nprobe - ref.tuned_nprobe) <= ref.tuned_nprobe // 2


def test_normalize_keep_dtype_equals_reference():
    """The chunked bf16 normalize (no f32 copy of the corpus) against the
    JAX package's, across a chunk boundary: bf16 out, values within one
    bf16 ulp (the two packages' f32 norms may differ in the last bit and
    round a value across a bf16 boundary); and a build from unnormalized
    bf16 rows equals the build from the rows it normalizes to."""
    rng = np.random.default_rng(12)
    x = (3 * rng.standard_normal((ivf.KMEANS_CHUNK + 100, D))).astype(np.float32)
    want = np.asarray(ref_ivf._normalize_keep_dtype(jnp.asarray(x.astype(ml_dtypes.bfloat16))))
    got = ivf._normalize_keep_dtype(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32),
                               rtol=2.0 ** -7, atol=0)
    a = IVFIndex.build(torch.from_numpy(x).to(torch.bfloat16), nlist=16, iters=3)
    b = IVFIndex.build(got, nlist=16, iters=3, pre_normalized=True)
    assert torch.equal(a.centroids, b.centroids) and torch.equal(a.bucket_ids, b.bucket_ids)


def test_auto_nprobe_recall_at_48(corpus, port_ivf):
    """The calibrated nprobe keeps recall@48 at the JAX package's >= 0.99
    contract (tests/test_ivf.py)."""
    q = _queries(corpus, n=20, seed=7, noise=0.05)
    _, exact_i = exact_search_batch(torch.from_numpy(corpus), q, 48)
    _, got = port_ivf.search_batch(q, 48)
    hits = sum(len(set(a) & set(b)) for a, b in zip(exact_i.tolist(), got.tolist()))
    assert hits / exact_i.size >= 0.99


def test_full_probe_equals_exact(corpus, port_ivf):
    q = _queries(corpus, n=4, seed=2, noise=1.0)
    es, ei = exact_search_batch(torch.from_numpy(corpus), q, 20)
    s, i = port_ivf.search_batch(q, 20, nprobe=NLIST)
    np.testing.assert_array_equal(i, ei)
    np.testing.assert_allclose(s, es, rtol=0, atol=1e-5)


def test_spill_rows_always_found():
    rng = np.random.default_rng(3)
    emb = rng.standard_normal((500, 32)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    index = IVFIndex.build(emb, nlist=4, bucket_factor=0.1, iters=3, device="cpu")
    assert index.spill.shape[0] > 0
    for row in (250, int(index.spill_ids[0])):
        _, idx = index.search(emb[row], 1, nprobe=1)
        assert int(idx[0]) == row
        _, idx = index.search_host(emb[row], 1, nprobe=1)
        assert int(idx[0]) == row


def test_short_results_are_padded(tmp_path):
    """Probes that cover fewer than k rows: search_batch pads with id -1
    and score NEG_INF, as the JAX package does on the same sidecar;
    search and search_host return the covered rows only."""
    rng = np.random.default_rng(7)
    emb = rng.standard_normal((500, 32)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    ref = RefIVF.build(emb, nlist=10, bucket_factor=4.0, iters=3, tune_target=None)
    ref.save(tmp_path / "ivf.npz")
    port = IVFIndex.load(tmp_path / "ivf.npz", device="cpu")
    q = emb[:3]
    s, i = port.search_batch(q, 100, nprobe=1)
    rs, ri = ref.search_batch(q, 100, nprobe=1)
    np.testing.assert_array_equal(i, ri)
    pad = i < 0
    assert pad.any() and (s[pad] == NEG_INF).all() and (rs[pad] == NEG_INF).all()
    assert (np.diff(pad.astype(int), axis=1) >= 0).all()  # pads come last
    for qi in range(3):
        real = i[qi][~pad[qi]]
        np.testing.assert_allclose(s[qi][~pad[qi]], emb[real] @ q[qi], atol=1e-5)
    ss, si = port.search(q[0], 100, nprobe=1)
    assert len(si) == (~pad[0]).sum() < 100 and (si >= 0).all()
    hs, hi = port.search_host(q[0], 100, nprobe=1)
    np.testing.assert_array_equal(hi, si)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_search_host_equals_search_batch(dtype, corpus, ref_sidecars):
    _, path = ref_sidecars[dtype]
    dev = IVFIndex.load(path, device="cpu")
    host = IVFIndex.load(path, host=True)
    assert isinstance(host.buckets, np.ndarray)
    assert host.buckets.dtype == (np.uint16 if dtype == "bf16" else np.float32)
    q = _queries(corpus, n=5, seed=21, noise=1.0)
    s, i = dev.search_batch(q, 20, nprobe=16)
    for qi in range(len(q)):
        hs, hi = host.search_host(q[qi], 20, nprobe=16)
        np.testing.assert_array_equal(hi, i[qi])
        np.testing.assert_allclose(hs, s[qi], rtol=0, atol=SCORE_ATOL)
    # a host-loaded index also answers search_batch, on the CPU
    hs, hi = host.search_batch(q, 20, nprobe=16)
    np.testing.assert_array_equal(hi, i)


def test_nprobe_from_ranks_equals_reference(corpus, ref_sidecars):
    """The calibration's tail on the same centroids, assignment, spill
    flags, queries and exact top-k."""
    ref, _ = ref_sidecars["f32"]
    cent = np.array(ref.centroids)
    assign = np.array(ref_ivf._assign(jnp.asarray(corpus), jnp.asarray(cent)))
    spilled = np.zeros(len(corpus), bool)
    spilled[np.asarray(ref.spill_ids)] = True
    q = _queries(corpus, n=64, seed=9, noise=0.05)
    _, exact_i = exact_search_batch(torch.from_numpy(corpus), q, 48)
    for target in (0.9, 0.995, 1.0):
        want = ref_ivf.nprobe_from_ranks(
            jnp.asarray(cent), jnp.asarray(assign), jnp.asarray(spilled),
            jnp.asarray(q), exact_i, target)
        got = ivf.nprobe_from_ranks(
            torch.from_numpy(cent), torch.from_numpy(assign).long(),
            torch.from_numpy(spilled), torch.from_numpy(q), exact_i, target)
        assert got == want


def test_sample_tuning_queries_stays_in_step(corpus):
    """The port draws the same rows and spends the same numpy draw on the
    noise seed as the reference, so later draws agree."""
    r1, r2 = np.random.default_rng(4), np.random.default_rng(4)
    q = ivf.sample_tuning_queries(torch.from_numpy(corpus), r1, 64, 0.05)
    ref_ivf.sample_tuning_queries(jnp.asarray(corpus), r2, 64, 0.05)
    assert r1.integers(1 << 30) == r2.integers(1 << 30)
    assert q.shape == (64, D)
    np.testing.assert_allclose(torch.linalg.norm(q, dim=1).numpy(), 1.0, atol=1e-6)
    rows = np.random.default_rng(4).choice(len(corpus), 64, replace=False)
    # noise of norm 0.05 * sqrt(d) = 0.4: cosine about 0.93 to its row
    assert ((q.numpy() * corpus[rows]).sum(1) > 0.85).all()


@pytest.mark.slow
def test_recall_at_scale_100k():
    """tests/test_ivf.py's scale case: 100k clustered rows, chunked
    k-means past KMEANS_CHUNK, recall@48 >= 0.99 at the auto nprobe."""
    rng = np.random.default_rng(0)
    n, d, n_clusters = 100_000, 128, 300
    assert n > ivf.KMEANS_CHUNK
    centers = rng.standard_normal((n_clusters, d)).astype(np.float32)
    emb = centers[rng.integers(0, n_clusters, n)] + 0.25 * rng.standard_normal(
        (n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    index = IVFIndex.build(emb, nlist=316, iters=8, device="cpu")
    hits = total = 0
    for _ in range(20):
        q = emb[rng.integers(0, n)] + 0.05 * rng.standard_normal(d).astype(np.float32)
        q /= np.linalg.norm(q)
        _, exact_i = exact_search_host(emb, q, 48)
        _, i = index.search(q, 48)
        hits += len(set(map(int, i)) & set(map(int, exact_i)))
        total += 48
    assert hits / total >= 0.99


# -- the engine's IVF routes (tests/test_ivf_persistence.py, ported) --

TINY = CLIPModelSpec(
    name="tiny", image_size=64, patch_size=16, vision_width=64,
    vision_layers=2, vision_heads=4, text_width=48, text_layers=2,
    text_heads=4, vocab_size=49408, context_length=77, embed_dim=D,
)
N_ENGINE = 3000  # 768 KB of f32 rows: IVF needs 3x, over a 1 MB budget


def _engine(monkeypatch, tmp_path, **env):
    for key in list(os.environ):
        if key.startswith("EVOSSEARCH_"):
            monkeypatch.delenv(key)
    monkeypatch.setenv("EVOSSEARCH_INDEX_KIND", "ivf")
    monkeypatch.setenv("EVOSSEARCH_COMPUTE_DTYPE", "float32")
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    return SearchEngine(cfg=Config(env_path=tmp_path / "missing.env"), spec=TINY,
                        device="cpu")


@pytest.fixture()
def folder(tmp_path):
    folder = tmp_path / "photos"
    folder.mkdir()
    emb = _clustered_corpus(N_ENGINE, seed=3)
    w = IndexWriter.create(folder, model="tiny", dim=D)
    paths = [str(folder / f"img_{i:05d}.jpg") for i in range(N_ENGINE)]
    w.append(emb, paths, [{"path": p, "mtime": 1.0, "size": 10} for p in paths])
    w.finalize()
    return folder, emb


def test_engine_persists_reloads_and_retrains_stale(monkeypatch, tmp_path, folder):
    folder, emb = folder
    sidecar = folder / ".clip_index" / "ivf.npz"
    q = _queries(emb, n=2, seed=11)
    eng = _engine(monkeypatch, tmp_path)
    s1, i1, _ = eng.search_embedding(str(folder), q[0], 10)
    assert sidecar.exists() and eng.counters.snapshot()["ivf_builds"] == 1
    want_s, want_i = IVFIndex.load(sidecar, device="cpu").search(q[0], 10)
    np.testing.assert_array_equal(i1, want_i)
    snap = eng.hbm_snapshot()["folders"][_canon(str(folder))]
    assert snap["tiers"] == ["ivf"] and snap["device_bytes"] == 3 * N_ENGINE * D * 4
    assert not eng._fused_text_eligible(*eng._cached_index(str(folder)))
    # under IVF, a fresh text takes encode-then-route, not the fused batch
    st, it, _ = eng.search_text(str(folder), "a photo", 5)
    se, ie, _ = eng.search_embedding(str(folder), eng.encode_text("a photo"), 5)
    np.testing.assert_array_equal(it, ie)
    eng.close()

    # a restarted server loads the sidecar instead of retraining
    def boom(*a, **kw):
        raise AssertionError("IVF retrained despite a fresh sidecar")

    monkeypatch.setattr(IVFIndex, "build", classmethod(boom))
    eng2 = _engine(monkeypatch, tmp_path)
    s2, i2, _ = eng2.search_embedding(str(folder), q[0], 10)
    np.testing.assert_array_equal(i2, i1)
    assert "ivf_builds" not in eng2.counters.snapshot()
    eng2.close()
    monkeypatch.undo()

    # a sidecar older than the store, or built at another nlist, is stale
    old = sidecar.stat().st_mtime - 100
    os.utime(sidecar, (old, old))
    eng3 = _engine(monkeypatch, tmp_path)
    s3, i3, _ = eng3.search_embedding(str(folder), q[0], 10)
    assert eng3.counters.snapshot()["ivf_builds"] == 1
    assert sidecar.stat().st_mtime > old
    np.testing.assert_array_equal(i3, i1)
    eng3.close()
    eng4 = _engine(monkeypatch, tmp_path, EVOSSEARCH_IVF_NLIST="20")
    eng4.search_embedding(str(folder), q[0], 10)
    assert eng4.counters.snapshot()["ivf_builds"] == 1
    assert IVFIndex.load(sidecar, host=True).nlist == 20
    eng4.close()


@pytest.mark.parametrize("microbatch_ms", ["0", "2"])
def test_engine_over_budget_takes_the_host_ivf(monkeypatch, tmp_path, folder,
                                               microbatch_ms):
    """A folder whose IVF does not fit the budget is served by the host
    probe of its persisted sidecar, counted; its ids are the device
    IVF's. Without a sidecar it falls back to the exact host scan."""
    folder, emb = folder
    q = _queries(emb, n=3, seed=13)
    eng = _engine(monkeypatch, tmp_path, EVOSSEARCH_MICROBATCH_MS=microbatch_ms)
    dev = [eng.search_embedding(str(folder), q[j], 10) for j in range(3)]
    eng.close()
    over = _engine(monkeypatch, tmp_path, EVOSSEARCH_HBM_BUDGET_MB="1",
                   EVOSSEARCH_MICROBATCH_MS=microbatch_ms)
    for j in range(3):
        s, i, _ = over.search_embedding(str(folder), q[j], 10)
        np.testing.assert_array_equal(i, dev[j][1])
        np.testing.assert_allclose(s, dev[j][0], rtol=0, atol=SCORE_ATOL)
    snap = over.counters.snapshot()
    assert snap["ivf_host_queries"] == 3 and snap["host_routed_queries"] == 3
    entry, reader = over._cached_index(str(folder))
    assert not over._fits_device(entry, reader) and "ivf" not in entry
    assert entry.get("device_bytes", 0) == 0
    over.close()
    (folder / ".clip_index" / "ivf.npz").unlink()
    bare = _engine(monkeypatch, tmp_path, EVOSSEARCH_HBM_BUDGET_MB="1",
                   EVOSSEARCH_MICROBATCH_MS=microbatch_ms, EVOSSEARCH_SQ8="off")
    s, i, _ = bare.search_embedding(str(folder), q[0], 10)
    es, ei = exact_search_host(emb, q[0], 10)
    np.testing.assert_array_equal(i, ei)
    assert "ivf_host_queries" not in bare.counters.snapshot()
    bare.close()


def test_engine_concurrent_ivf_searches_batch(monkeypatch, tmp_path, folder):
    """Concurrent IVF searches share the device batcher; each gets its own
    rows, equal to a lone search's."""
    import threading

    folder, emb = folder
    q = _queries(emb, n=6, seed=17)
    eng = _engine(monkeypatch, tmp_path, EVOSSEARCH_MICROBATCH_MS="5")
    alone = [eng.search_embedding(str(folder), q[j], 7) for j in range(6)]
    out = [None] * 6

    def run(j):
        out[j] = eng.search_embedding(str(folder), q[j], 7)

    threads = [threading.Thread(target=run, args=(j,)) for j in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for j in range(6):
        np.testing.assert_array_equal(out[j][1], alone[j][1])
    assert eng.counters.snapshot()["ivf_builds"] == 1
    eng.close()
