"""The port against tests/test_profiling_and_scale.py: profiling hooks
produce traces; store round-trips at larger scale.

Harness only: ``capture_trace`` (``torch.profiler`` in the port) wraps a
torch product where the JAX file traces a ``jnp`` one, and the engine is
made on the CPU."""

import numpy as np
import torch

from evossearch_tpu_torch.index import IndexReader, IndexWriter, exact_search
from evossearch_tpu_torch.utils.profiling import annotate, capture_trace


def test_capture_trace_writes_profile(tmp_path):
    with capture_trace(str(tmp_path)):
        with annotate("test-region"):
            torch.ones((64, 64)) @ torch.ones((64, 64))
    produced = list(tmp_path.rglob("*"))
    assert any(p.is_file() for p in produced), produced


def test_capture_trace_noop_without_dir(monkeypatch):
    monkeypatch.delenv("EVOSSEARCH_PROFILE_DIR", raising=False)
    with capture_trace(None):
        pass  # must not raise or start a profiler


def test_capture_trace_is_not_reentrant(tmp_path):
    """The profiler allows ONE active trace per process; a nested/
    concurrent capture must proceed untraced instead of raising."""
    with capture_trace(str(tmp_path)):
        with capture_trace(str(tmp_path)):  # would raise without the guard
            torch.ones((8, 8)) @ torch.ones((8, 8))


def test_search_route_captures_trace(tmp_path, monkeypatch):
    """EVOSSEARCH_PROFILE_DIR wires /search (and the StageTimer spans
    under it) into an xprof trace directory — VERDICT r2 missing #2."""
    from PIL import Image

    from evossearch_tpu_torch.core import Config
    from evossearch_tpu_torch.core.constants import CLIPModelSpec
    from evossearch_tpu_torch.engine import SearchEngine
    from evossearch_tpu_torch.server import TestClient, create_app

    tiny = CLIPModelSpec(
        name="tiny", image_size=64, patch_size=16, vision_width=64,
        vision_layers=2, vision_heads=4, text_width=48, text_layers=2,
        text_heads=4, vocab_size=49408, context_length=77, embed_dim=32,
    )
    folder = tmp_path / "imgs"
    folder.mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        arr = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
        Image.fromarray(arr).save(folder / f"i{i}.jpg", quality=90)
    trace_dir = tmp_path / "traces"
    for k in ("EVOSSEARCH_CHECKPOINT", "EVOSSEARCH_BPE_VOCAB"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("EVOSSEARCH_PROFILE_DIR", str(trace_dir))
    cfg = Config(env_path=tmp_path / "missing.env")
    engine = SearchEngine(cfg=cfg, spec=tiny, device="cpu")
    try:
        client = TestClient(create_app(engine=engine, cfg=cfg))
        r = client.post("/index", json_body={"folder": str(folder)})
        assert r.status_code == 200, r.json
        r = client.post("/search", json_body={
            "folder": str(folder), "query": "anything", "limit": 3,
        })
        assert r.status_code == 200, r.json
        produced = [p for p in trace_dir.rglob("*") if p.is_file()]
        assert produced, "no trace files captured under EVOSSEARCH_PROFILE_DIR"
    finally:
        engine.close()


def test_store_200k_rows_roundtrip_and_search(tmp_path):
    rng = np.random.default_rng(0)
    n, d = 200_000, 64
    emb = rng.standard_normal((n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    w = IndexWriter.create(tmp_path, model="m", dim=d, rows_per_shard=65536)
    step = 50_000
    for s in range(0, n, step):
        w.append(
            emb[s : s + step],
            [f"/p/{i}.jpg" for i in range(s, s + step)],
            [{"path": str(i), "mtime": 0.0, "size": 1} for i in range(s, s + step)],
        )
    w.finalize()
    r = IndexReader.open(tmp_path, verify_checksums=True)
    assert r is not None and r.count == n
    assert len(r.shard_arrays()) == 4
    q = emb[123_456]
    scores, idx = exact_search(r.embeddings(), q, 10)
    assert int(idx[0]) == 123_456
    assert scores[0] > 0.999
