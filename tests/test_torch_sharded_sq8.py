"""The port's mesh-sharded SQ8 tier against the JAX package's, on the CPU:
the counterparts of tests/test_sharded_sq8.py.

One sidecar, built by the port, serves both packages: the JAX
``SQ8ShardedIndex`` on the conftest's 8 forced host devices (its Pallas
bound sweep in interpret mode) and the port's on ``[cpu] * 8`` (the sweep's
plain version). Certified results must rank as the host oracle does
(score desc, index asc), equal the JAX package's and the port's one-device
tier's, whatever the block count; uncertified queries fall back to the host
scan."""

from __future__ import annotations

import os

import numpy as np
import pytest

from evossearch_tpu.index import sq8 as ref_sq8
from evossearch_tpu.index.store import IndexReader as RefReader
from evossearch_tpu.parallel import SQ8ShardedIndex as RefSQ8Sharded
from evossearch_tpu.parallel import corpus_mesh as ref_mesh
from evossearch_tpu_torch.core import Config
from evossearch_tpu_torch.core.constants import CLIPModelSpec
from evossearch_tpu_torch.engine import SearchEngine, _canon
from evossearch_tpu_torch.index.sq8 import DEFAULT_FETCH, SQ8Index
from evossearch_tpu_torch.index.store import IndexReader, IndexWriter
from evossearch_tpu_torch.parallel import SQ8ShardedIndex, corpus_mesh, mesh

D = 256
K = 20
SCORE_ATOL = 2e-6  # BLAS f32 reduction order of the two packages' reranks
TILE = 512  # test-sized tiles (the default is sized for millions of rows)


def _store(folder, emb):
    folder.mkdir(exist_ok=True)
    w = IndexWriter.create(folder, model="tiny", dim=D, dtype_name="float32")
    paths = [str(folder / f"img_{i:05d}.jpg") for i in range(len(emb))]
    w.append(emb, paths, [{"path": p, "mtime": 1.0, "size": 1} for p in paths])
    w.finalize()
    return IndexReader.open(folder)


def _unit(rng, n):
    emb = rng.standard_normal((n, D)).astype(np.float32)
    return emb / np.linalg.norm(emb, axis=1, keepdims=True)


def _oracle(emb, queries, k):
    s_all = emb @ queries.T  # f32 store: raw f32 query, like the host scan
    out_s, out_i = [], []
    for qi in range(queries.shape[0]):
        o = np.lexsort((np.arange(emb.shape[0]), -s_all[:, qi]))[:k]
        out_s.append(s_all[o, qi])
        out_i.append(o)
    return np.array(out_s), np.array(out_i)


def _tiers(folder, emb, fetch):
    """(port one-device tier, port sharded tier, JAX sharded tier) on one
    sidecar, which the port builds and the JAX package loads."""
    reader = _store(folder, emb)
    base = SQ8Index.build_from_reader(reader, fetch=fetch)
    base.tile_rows = TILE
    base.ensure_device("cpu")
    sharded = SQ8ShardedIndex(base, corpus_mesh(devices=["cpu"] * 8))
    ref_base = ref_sq8.SQ8Index.load(RefReader.open(folder), fetch=fetch)
    assert ref_base is not None
    ref_base.tile_rows = TILE
    return base, sharded, RefSQ8Sharded(ref_base, ref_mesh(8))


def _agree(tiers, emb, queries, k):
    base, sharded, ref = tiers
    s, i = sharded.search_batch(queries, k)
    assert i.dtype == np.int64 and s.dtype == np.float32
    es, ei = _oracle(emb, queries, k)
    np.testing.assert_array_equal(i, ei)
    np.testing.assert_allclose(s, es, rtol=0, atol=SCORE_ATOL)
    s1, i1 = base.search_batch(queries, k)
    np.testing.assert_array_equal(i, i1)
    np.testing.assert_array_equal(s, s1)
    rs, ri = ref.search_batch(queries, k)
    np.testing.assert_array_equal(i, ri)
    np.testing.assert_allclose(s, rs, rtol=0, atol=SCORE_ATOL)
    return s, i


@pytest.mark.parametrize("n,fetch", [(4096, DEFAULT_FETCH), (7000, 64)])
def test_sharded_equals_oracle_reference_and_single_device(tmp_path, n, fetch):
    """8 blocks rank as the oracle, the JAX package and the one-device
    tier do; n = 7000 also pads the last block and fetches below each
    block's candidate total (real certificates)."""
    emb = _unit(np.random.default_rng(1), n)
    tiers = _tiers(tmp_path / "a", emb, fetch)
    sharded = tiers[1]
    assert sharded.rows_per_shard == -(-n // 8)
    sharded.ensure_device()
    # pad rows: scale 0, radd -inf
    last = sharded._scal2_d[-1]
    valid = int(sharded.counts[-1])
    assert (last[1, valid:] == -np.inf).all() and (last[0, valid:] == 0).all()
    queries = _unit(np.random.default_rng(2), 5)
    _agree(tiers, emb, queries, K)


def test_sharded_mass_ties_stay_exact(tmp_path):
    """One row repeated 512 times across every block: the fallback keeps
    the lowest-index tie rule across block borders."""
    rng = np.random.default_rng(3)
    emb = _unit(rng, 2048)
    emb[::4] = emb[0]
    tiers = _tiers(tmp_path / "a", emb, 64)
    q = emb[0] + 1e-4 * rng.standard_normal(D).astype(np.float32)
    q /= np.linalg.norm(q)
    _agree(tiers, emb, q[None].astype(np.float32), 40)


def test_tiny_corpus_full_fetch_no_duplicate_ids(tmp_path):
    """100 rows over 8 blocks at full fetch: the kernel's tail-masked
    cells (finite sentinel, aliased ids) and the pad rows reach the global
    merge, and the sentinel filter keeps every id unique."""
    emb = _unit(np.random.default_rng(7), 100)
    tiers = _tiers(tmp_path / "a", emb, DEFAULT_FETCH)
    queries = _unit(np.random.default_rng(8), 3)
    s, i = _agree(tiers, emb, queries, 20)
    for qi in range(3):
        assert len(set(i[qi].tolist())) == 20, f"duplicate ids: {i[qi]}"


def test_over_128_query_batches_chunk(tmp_path):
    """129 queries: the kernel takes 128 per pass, both tiers chunk."""
    emb = _unit(np.random.default_rng(9), 2048)
    tiers = _tiers(tmp_path / "a", emb, 64)
    queries = _unit(np.random.default_rng(10), 129)
    s, i = _agree(tiers, emb, queries, 10)
    assert s.shape == (129, 10)


TINY = CLIPModelSpec(
    name="tiny", image_size=64, patch_size=16, vision_width=64,
    vision_layers=2, vision_heads=4, text_width=48, text_layers=2,
    text_heads=4, vocab_size=49408, context_length=77, embed_dim=D,
)


def test_engine_sharded_kernel_gets_sharded_sq8(monkeypatch, tmp_path):
    """SEARCH_KERNEL=sharded and a folder over the per-device budget: the
    engine installs the mesh-sharded SQ8 tier, reserves the per-device
    share of the sidecar, and serves the exact results through it."""
    monkeypatch.setattr(mesh, "available_devices", lambda device: [device] * 8)
    n = 24000
    folder = tmp_path / "a"
    emb = _unit(np.random.default_rng(4), n)
    _store(folder, emb)
    for key in list(os.environ):
        if key.startswith("EVOSSEARCH_"):
            monkeypatch.delenv(key)
    # corpus per device = 24000*256*4/8 = 3.1 MB > 2 MB; sidecar per
    # device = 24000*264/8 = 0.79 MB: the sharded SQ8 tier
    monkeypatch.setenv("EVOSSEARCH_HBM_BUDGET_MB", "2")
    monkeypatch.setenv("EVOSSEARCH_SEARCH_KERNEL", "sharded")
    monkeypatch.setenv("EVOSSEARCH_MICROBATCH_MS", "0")
    eng = SearchEngine(cfg=Config(env_path=tmp_path / "missing.env"), spec=TINY,
                       device="cpu")
    q = np.random.default_rng(5).standard_normal(D).astype(np.float32)
    q /= np.linalg.norm(q)
    s, i, _ = eng.search_embedding(str(folder), q, 10)
    es, ei = _oracle(emb, q[None], 10)
    np.testing.assert_array_equal(i, ei[0])
    np.testing.assert_allclose(s, es[0], rtol=0, atol=SCORE_ATOL)
    entry = eng._index_cache[_canon(str(folder))]
    assert isinstance(entry["sq8"], SQ8ShardedIndex)
    assert entry["sq8"].mesh.size == 8 and "emb" not in entry
    assert entry["device_bytes"] == n * (D + 8) // 8
    assert eng.counters.snapshot()["sq8_queries"] == 1
    eng.close()
