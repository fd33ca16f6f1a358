"""The engine's sharded routes and data-parallel encode, on the CPU.

``parallel.mesh.available_devices`` is monkeypatched to ``[cpu] * 8``, the
port's counterpart of the conftest's 8 forced XLA host devices, so the
engine sees eight devices: ``SEARCH_KERNEL=auto`` resolves to ``sharded``,
``INDEX_KIND=ivf`` serves the mesh-sharded IVF and its ``ivf_mesh8.npz``
sidecar, and ``DP_ENCODE`` splits each encode batch over the eight. The
counterparts of tests/test_engine_kernels.py:44-100 (the sharded case,
auto, IVF under sharded), tests/test_hbm_budget.py:225-240 (the
reservation before the corpus is placed), tests/test_ivf_persistence.py:40
(the sidecar persisted and reloaded) and tests/test_round2_fixes.py:178
(DP encode against one device)."""

import os

import numpy as np
import pytest
import torch

from evossearch_tpu.core import Config as RefConfig
from evossearch_tpu.engine import SearchEngine as RefEngine
from evossearch_tpu_torch.core import Config
from evossearch_tpu_torch.core.constants import CLIPModelSpec
from evossearch_tpu_torch.engine import SearchEngine, _canon
from evossearch_tpu_torch.index.store import IndexWriter
from evossearch_tpu_torch.parallel import (
    ShardedIndex, ShardedIVFIndex, mesh,
)

TINY = CLIPModelSpec(
    name="tiny", image_size=64, patch_size=16, vision_width=64,
    vision_layers=2, vision_heads=4, text_width=48, text_layers=2,
    text_heads=4, vocab_size=49408, context_length=77, embed_dim=32,
)
D = TINY.embed_dim
SCORE_ATOL = 1e-5


@pytest.fixture()
def eight(monkeypatch):
    """Eight devices for every engine of the test."""
    monkeypatch.setattr(mesh, "available_devices", lambda device: [torch.device(device)] * 8)


def _env(monkeypatch, **env):
    for key in list(os.environ):
        if key.startswith("EVOSSEARCH_"):
            monkeypatch.delenv(key)
    monkeypatch.setenv("EVOSSEARCH_COMPUTE_DTYPE", "float32")
    for key, val in env.items():
        monkeypatch.setenv(key, val)


def _engine(monkeypatch, tmp_path, **env):
    _env(monkeypatch, **env)
    return SearchEngine(cfg=Config(env_path=tmp_path / "missing.env"), spec=TINY,
                        device="cpu")


def _folder(root, n, seed=0):
    """A folder with an n-row float32 store of unit rows."""
    folder = root / f"photos_{n}"
    folder.mkdir()
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((n, D)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    w = IndexWriter.create(folder, model="tiny", dim=D)
    paths = [str(folder / f"img_{i:05d}.jpg") for i in range(n)]
    w.append(emb, paths, [{"path": p, "mtime": 1.0, "size": 10} for p in paths])
    w.finalize()
    return folder, emb


def _query(seed):
    q = np.random.default_rng(seed).standard_normal(D).astype(np.float32)
    return q / np.linalg.norm(q)


@pytest.mark.parametrize("kernel", ["xla", "pallas", "host", "sharded"])
def test_all_kernels_agree(monkeypatch, tmp_path, eight, kernel):
    folder, _ = _folder(tmp_path, 1003)
    q = _query(1)
    base = _engine(monkeypatch, tmp_path, EVOSSEARCH_SEARCH_KERNEL="xla")
    s0, i0, _ = base.search_embedding(str(folder), q, 12)
    eng = _engine(monkeypatch, tmp_path, EVOSSEARCH_SEARCH_KERNEL=kernel)
    s1, i1, _ = eng.search_embedding(str(folder), q, 12)
    np.testing.assert_array_equal(i1, i0)
    np.testing.assert_allclose(s1, s0, rtol=0, atol=SCORE_ATOL)
    entry = eng._index_cache[_canon(str(folder))]
    if kernel == "sharded":
        assert isinstance(entry["sharded"], ShardedIndex) and "emb" not in entry
        assert entry["sharded"].mesh.size == 8
        assert entry["device_bytes"] == 1003 * D * 4 // 8
        assert eng.hbm_snapshot()["folders"][_canon(str(folder))]["tiers"] == ["sharded"]
    base.close()
    eng.close()


def test_auto_kernel_resolves(monkeypatch, tmp_path):
    folder, emb = _folder(tmp_path, 500)
    one = _engine(monkeypatch, tmp_path)  # the CPU alone: one device
    assert one._resolve_kernel() == "best" and one._encode_devices is None
    monkeypatch.setattr(mesh, "available_devices", lambda device: [torch.device(device)] * 8)
    eng = _engine(monkeypatch, tmp_path)  # auto; eight devices -> sharded
    assert eng._resolve_kernel() == "sharded" and len(eng._encode_devices) == 8
    q = _query(2)
    s, i, _ = eng.search_embedding(str(folder), q, 3)
    assert len(s) == 3
    np.testing.assert_array_equal(i, np.argsort(-(emb @ q), kind="stable")[:3])
    # text searches take the batcher to the sharded route (no fused path)
    res = eng.search_text(str(folder), "a photo of a dog", 5)
    assert res is not None and len(res[1]) == 5
    assert eng.counters.snapshot()["queries"] == 2
    one.close()
    eng.close()


def test_sharded_engine_equals_reference_engine(monkeypatch, tmp_path, eight):
    """The port's sharded route and the JAX package's, on one folder."""
    folder, _ = _folder(tmp_path, 777)
    _env(monkeypatch, EVOSSEARCH_SEARCH_KERNEL="sharded", EVOSSEARCH_MICROBATCH_MS="0")
    env = tmp_path / "missing.env"
    port = SearchEngine(cfg=Config(env_path=env), spec=TINY, device="cpu")
    ref = RefEngine(cfg=RefConfig(env_path=env), spec=TINY)
    for seed in (3, 4):
        q = _query(seed)
        ps, pi, _ = port.search_embedding(str(folder), q, 20)
        rs, ri, _ = ref.search_embedding(str(folder), q, 20)
        np.testing.assert_array_equal(pi, ri)
        np.testing.assert_allclose(ps, rs, rtol=0, atol=1e-6)
    port.close()
    ref.close()


def test_ivf_sharded_kernel(monkeypatch, tmp_path, eight):
    """INDEX_KIND=ivf + SEARCH_KERNEL=sharded serves the mesh-sharded IVF,
    persists its mesh-size-specific sidecar, agrees with the exact sharded
    route, and a fresh engine reloads the sidecar without rebuilding."""
    folder, _ = _folder(tmp_path, 64)
    q = _query(5)
    eng = _engine(monkeypatch, tmp_path, EVOSSEARCH_SEARCH_KERNEL="sharded",
                  EVOSSEARCH_INDEX_KIND="ivf")
    s, i, reader = eng.search_embedding(str(folder), q, 10)
    assert len(s) == 10 and len(set(i.tolist())) == 10
    entry = eng._index_cache[_canon(str(folder))]
    assert isinstance(entry.get("sharded_ivf"), ShardedIVFIndex)
    assert entry["device_bytes"] == 3 * 64 * D * 4 // 8
    assert (reader.root / "ivf_mesh8.npz").exists()
    assert not (reader.root / "ivf.npz").exists()
    assert eng.counters.snapshot()["ivf_builds"] == 1

    exact = _engine(monkeypatch, tmp_path, EVOSSEARCH_SEARCH_KERNEL="sharded")
    es, ei, _ = exact.search_embedding(str(folder), q, 10)
    np.testing.assert_array_equal(i, ei)  # 64 rows: the auto nprobe probes all
    np.testing.assert_allclose(s, es, rtol=0, atol=SCORE_ATOL)

    eng2 = _engine(monkeypatch, tmp_path, EVOSSEARCH_SEARCH_KERNEL="sharded",
                   EVOSSEARCH_INDEX_KIND="ivf")
    monkeypatch.setattr(
        ShardedIVFIndex, "build",
        classmethod(lambda *a, **k: pytest.fail("rebuilt despite the sidecar")),
    )
    s2, i2, _ = eng2.search_embedding(str(folder), q, 10)
    np.testing.assert_array_equal(i2, i)
    assert "ivf_builds" not in eng2.counters.snapshot()
    for e in (eng, exact, eng2):
        e.close()


def test_ivf_mesh_sidecar_persisted_and_reloaded(monkeypatch, tmp_path, eight):
    """Under auto on eight devices INDEX_KIND=ivf writes ivf_mesh8.npz,
    not the one-device ivf.npz; a restart reloads it; a mesh of another
    size (MESH_DEVICES=4) builds and keeps its own ivf_mesh4.npz."""
    folder, _ = _folder(tmp_path, 300)
    q = _query(6)
    eng = _engine(monkeypatch, tmp_path, EVOSSEARCH_INDEX_KIND="ivf")
    s1, i1, reader = eng.search_embedding(str(folder), q, 5)
    assert (reader.root / "ivf_mesh8.npz").exists()
    assert not (reader.root / "ivf.npz").exists()
    eng2 = _engine(monkeypatch, tmp_path, EVOSSEARCH_INDEX_KIND="ivf")
    s2, i2, _ = eng2.search_embedding(str(folder), q, 5)
    np.testing.assert_array_equal(i1, i2)
    assert "ivf_builds" not in eng2.counters.snapshot()
    eng4 = _engine(monkeypatch, tmp_path, EVOSSEARCH_INDEX_KIND="ivf",
                   EVOSSEARCH_MESH_DEVICES="4")
    eng4.search_embedding(str(folder), q, 5)
    entry = eng4._index_cache[_canon(str(folder))]
    assert entry["sharded_ivf"].mesh.size == 4
    assert eng4.counters.snapshot()["ivf_builds"] == 1
    assert (reader.root / "ivf_mesh4.npz").exists()
    for e in (eng, eng2, eng4):
        e.close()


def test_reservation_precedes_device_put(monkeypatch, tmp_path, eight):
    """The sharded corpus and the sharded IVF reserve their per-device
    bytes before anything lands on a device, and a failed placement
    rolls the reservation back."""
    folder, emb = _folder(tmp_path, 400)
    ShardedIVFIndex.build(emb, mesh=mesh.corpus_mesh(devices=["cpu"] * 8), nlist=20,
                          iters=2).save(folder / ".clip_index" / "ivf_mesh8.npz")
    eng = _engine(monkeypatch, tmp_path, EVOSSEARCH_HBM_BUDGET_MB="100")
    entry, reader = eng._cached_index(str(folder))
    seen = {}
    orig_fr = ShardedIndex.from_reader.__func__

    def spy_from_reader(cls, reader_, mesh=None, n_devices=0):
        seen["sharded_reserved"] = entry.get("device_bytes", 0)
        if seen.setdefault("calls", 0) == 0:
            seen["calls"] = 1
            raise RuntimeError("transient device error")
        return orig_fr(cls, reader_, mesh=mesh, n_devices=n_devices)

    monkeypatch.setattr(ShardedIndex, "from_reader", classmethod(spy_from_reader))
    with pytest.raises(RuntimeError):
        eng._entry_sharded(entry, reader)
    assert entry.get("device_bytes", 0) == 0 and "sharded" not in entry
    eng._entry_sharded(entry, reader)
    assert seen["sharded_reserved"] == 400 * D * 4 // 8
    assert entry["device_bytes"] == 400 * D * 4 // 8  # charged once

    orig_load = ShardedIVFIndex.load.__func__

    def spy_load(cls, path, mesh=None):
        seen["ivf_reserved"] = entry.get("device_bytes", 0)
        return orig_load(cls, path, mesh=mesh)

    monkeypatch.setattr(ShardedIVFIndex, "load", classmethod(spy_load))
    eng.cfg.IVF_NLIST = 20
    entry.pop("device_bytes", None)
    assert isinstance(eng._entry_sharded_ivf(entry, reader), ShardedIVFIndex)
    assert seen["ivf_reserved"] == 3 * 400 * D * 4 // 8
    assert "ivf_builds" not in eng.counters.snapshot()
    eng.close()


def test_eviction_drops_the_sharded_tiers(monkeypatch, tmp_path, eight):
    """A second folder over the budget evicts the first one's sharded
    corpus."""
    a, _ = _folder(tmp_path, 4096, seed=1)
    b, _ = _folder(tmp_path, 4097, seed=2)
    eng = _engine(monkeypatch, tmp_path, EVOSSEARCH_SEARCH_KERNEL="sharded")
    # each corpus: 65,536 bytes per device of 8; the budget holds one
    eng.__dict__["_hbm_budget"] = 100_000
    eng.search_embedding(str(a), _query(7), 3)
    assert "sharded" in eng._index_cache[_canon(str(a))]
    eng.search_embedding(str(b), _query(8), 3)
    assert "sharded" not in eng._index_cache[_canon(str(a))]
    assert eng.counters.snapshot()["hbm_evictions"] == 1
    eng.close()


def _images(n=11):
    rng = np.random.default_rng(0)
    return [rng.integers(0, 256, (50, 70, 3), dtype=np.uint8) for _ in range(n)]


def _planar_batch(n=11):
    from evossearch_tpu_torch.preprocess import prepare_batch_planar

    rng = np.random.default_rng(1)
    planes = []
    for j in range(n):
        h, w = 50 + 3 * j, 70 - 2 * j  # ragged sizes
        ch, cw = (h + 1) // 2, (w + 1) // 2
        planes.append((rng.integers(0, 256, (h, w), dtype=np.uint8),
                       rng.integers(0, 256, (ch, cw), dtype=np.uint8),
                       rng.integers(0, 256, (ch, cw), dtype=np.uint8)))
    return prepare_batch_planar(planes, TINY.image_size)


@pytest.mark.parametrize("route", ["rgb", "planar"])
def test_dp_encode_matches_single_device(monkeypatch, tmp_path, eight, route):
    """11 images (a ragged count: padded to 16, two per device) split over
    eight devices give the single-device embeddings within 1e-6, f32."""
    _env(monkeypatch, EVOSSEARCH_DP_ENCODE="True")
    dp = SearchEngine(cfg=Config(env_path=tmp_path / "missing.env"), spec=TINY,
                      device="cpu")
    _env(monkeypatch, EVOSSEARCH_DP_ENCODE="False")
    one = SearchEngine(cfg=Config(env_path=tmp_path / "missing.env"), spec=TINY,
                       params=dp.params, device="cpu")
    assert len(dp._encode_devices) == 8 and one._encode_devices is None
    calls = []
    orig = SearchEngine._prep_encode_planar if route == "planar" else SearchEngine._prep_encode
    name = orig.__name__

    def spy(self, params, *args):
        calls.append(args[0].shape[0])
        return orig(self, params, *args)

    monkeypatch.setattr(SearchEngine, name, spy)
    if route == "rgb":
        emb_dp = dp.encode_images(_images())
        n_dp = list(calls)
        emb_1d = one.encode_images(_images())
    else:
        emb_dp = dp.encode_prepared_planar(*_planar_batch())
        n_dp = list(calls)
        emb_1d = one.encode_prepared_planar(*_planar_batch())
    assert n_dp == [2] * 8 and calls[8:] == [16]
    assert emb_dp.shape == (11, D) and np.isfinite(emb_dp).all()
    np.testing.assert_allclose(emb_dp, emb_1d, rtol=1e-6, atol=1e-6)
    assert dp.counters.snapshot()["images_encoded"] == 11
    dp.close()
    one.close()
