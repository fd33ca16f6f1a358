"""The port against tests/test_round2_fixes.py, the regression tests for
the round-2 advisor fixes (ADVICE.md round 1).

Harness only: the app's engine is made on the CPU (``create_app(...,
device="cpu")``); the DP-encode test sees eight devices through a
monkeypatched ``parallel.mesh.available_devices`` (the conftest's 8
forced XLA host devices in the JAX file), and the JAX engine's
``_encode_sharding`` is the port's ``_encode_devices``."""

import json
import os
import threading

import numpy as np
import pytest


def _mk_images(folder, n=3):
    from PIL import Image

    rng = np.random.default_rng(0)
    for i in range(n):
        arr = (rng.random((48, 48, 3)) * 255).astype("uint8")
        Image.fromarray(arr).save(folder / f"img{i}.jpg")


@pytest.fixture()
def app_client(tmp_path, monkeypatch):
    monkeypatch.setenv("EVOSSEARCH_MICROBATCH_MS", "0")
    from evossearch_tpu_torch.core.config import Config
    from evossearch_tpu_torch.server.app import create_app
    from evossearch_tpu_torch.server.web import TestClient

    cfg = Config()
    app = create_app(cfg=cfg, device="cpu")
    return TestClient(app), app, tmp_path


def test_oversized_body_rejected_413(app_client):
    client, app, _ = app_client
    # Craft a request whose Content-Length exceeds the cap; the server must
    # reject before reading/allocating the body.
    cap = app.max_body_bytes
    assert cap == app.cfg.MAX_FILE_SIZE_MB * 1024 * 1024 + 1024 * 1024
    import io

    environ = {
        "REQUEST_METHOD": "POST",
        "PATH_INFO": "/search",
        "QUERY_STRING": "",
        "CONTENT_TYPE": "application/json",
        "CONTENT_LENGTH": str(cap + 1),
        "wsgi.input": io.BytesIO(b"x"),  # tiny actual body; length header lies
        "wsgi.errors": io.StringIO(),
        "wsgi.url_scheme": "http",
        "SERVER_NAME": "test",
        "SERVER_PORT": "80",
    }
    captured = {}

    def start_response(status, headers):
        captured["status"] = int(status.split()[0])

    body = b"".join(app(environ, start_response))
    assert captured["status"] == 413
    assert b"too large" in body


def test_normal_body_still_accepted(app_client):
    client, app, _ = app_client
    r = client.post("/check_index", json_body={"folder": "/nonexistent-xyz"})
    assert r.status_code == 200


def test_folder_lock_key_is_canonical(tmp_path):
    from evossearch_tpu_torch.engine import SearchEngine, _canon

    eng = SearchEngine.__new__(SearchEngine)
    eng._cache_lock = threading.Lock()
    eng._folder_locks = {}
    sub = tmp_path / "a"
    sub.mkdir()
    spelled1 = str(sub)
    spelled2 = str(tmp_path / "b" / ".." / "a")
    (tmp_path / "b").mkdir()
    assert _canon(spelled1) == _canon(spelled2)
    assert eng._folder_lock(spelled1) is eng._folder_lock(spelled2)


def test_recover_skips_lockfile_for_unindexed_folder(tmp_path):
    # Opening a never-indexed folder must not create lock files in it
    # (the folder may be read-only; open() is a read path).
    from evossearch_tpu_torch.index.store import IndexReader

    assert IndexReader.open(tmp_path) is None
    assert list(tmp_path.iterdir()) == []


def test_recovery_still_promotes_staging(tmp_path):
    from evossearch_tpu_torch.index.store import IndexReader, IndexWriter

    w = IndexWriter.create(tmp_path, model="m", dim=4)
    w.append(np.eye(4, dtype=np.float32)[:2], ["a", "b"],
             [{"mtime": 0, "size": 1}] * 2)
    # Simulate a crash after staging was fully written but before the swap:
    # write manifest manually into the staging dir.
    (w.root / "paths.json").write_text(json.dumps(w._paths))
    (w.root / "metadata.json").write_text(json.dumps(w._metadata))
    w._flush_shard(w._open_count)
    (w.root / "manifest.json").write_text(json.dumps(w._manifest()))
    reader = IndexReader.open(tmp_path)  # triggers recovery promotion
    assert reader is not None and reader.count == 2


def test_finalize_tolerates_stolen_second_rename(tmp_path, monkeypatch):
    # If something promoted the fully-written staging dir between
    # finalize()'s two renames, the publish already succeeded — finalize
    # must not raise.
    from evossearch_tpu_torch.index import store as store_mod
    from evossearch_tpu_torch.index.store import IndexReader, IndexWriter

    w = IndexWriter.create(tmp_path, model="m", dim=4)
    w.append(np.eye(4, dtype=np.float32)[:2], ["a", "b"],
             [{"mtime": 0, "size": 1}] * 2)

    orig_rename = os.rename
    state = {"steal": True}

    def stealing_rename(src, dst):
        # Steal exactly the staging->live rename once.
        if state["steal"] and str(src) == str(w.root):
            state["steal"] = False
            orig_rename(src, dst)  # someone else promotes it first
            raise FileNotFoundError(src)
        return orig_rename(src, dst)

    import pathlib

    orig_path_rename = pathlib.Path.rename

    def patched(self, target):
        if state["steal"] and str(self) == str(w.root):
            state["steal"] = False
            orig_path_rename(self, target)
            raise FileNotFoundError(str(self))
        return orig_path_rename(self, target)

    monkeypatch.setattr(pathlib.Path, "rename", patched)
    w.finalize()  # must not raise
    monkeypatch.setattr(pathlib.Path, "rename", orig_path_rename)
    reader = IndexReader.open(tmp_path)
    assert reader is not None and reader.count == 2
    assert not (tmp_path / ".clip_index.old").exists()


def test_stage_timer_percentiles():
    # VERDICT round 1 item 8: /stats must expose query latency percentiles.
    from evossearch_tpu_torch.utils import StageTimer

    t = StageTimer()
    for _ in range(200):
        with t.stage("search"):
            pass
    snap = t.snapshot()["search"]
    assert snap["count"] == 200
    assert 0 <= snap["p50_ms"] <= snap["p99_ms"]
    assert snap["window"] == 200


def test_stats_route_exposes_percentiles(app_client, tmp_path):
    client, app, _ = app_client
    _mk_images(tmp_path)
    r = client.post("/index", json_body={"folder": str(tmp_path)})
    assert r.status_code == 200, r.data
    r = client.post(
        "/search",
        json_body={"folder": str(tmp_path), "query": "cat", "limit": 3},
    )
    assert r.status_code == 200
    stats = client.get("/stats").json
    assert "p50_ms" in stats["stage_timers"]["search"]
    assert "p99_ms" in stats["stage_timers"]["search"]


def test_dp_encode_sharded_matches_single_device(monkeypatch):
    # VERDICT round 1 item 7 / SURVEY §2 parallelism row 1: indexing encode
    # shards the batch axis over the mesh; embeddings must be identical to
    # single-device (per-image math is independent).
    import torch

    from evossearch_tpu_torch.core import Config
    from evossearch_tpu_torch.core.constants import CLIPModelSpec
    from evossearch_tpu_torch.engine import SearchEngine
    from evossearch_tpu_torch.parallel import mesh

    monkeypatch.setattr(mesh, "available_devices",
                        lambda device: [torch.device(device)] * 8)
    assert len(mesh.available_devices("cpu")) == 8  # an 8-device CPU mesh
    tiny = CLIPModelSpec(
        name="tiny", image_size=64, patch_size=16, vision_width=64,
        vision_layers=2, vision_heads=4, text_width=48, text_layers=2,
        text_heads=4, vocab_size=49408, context_length=77, embed_dim=32,
    )
    monkeypatch.setenv("EVOSSEARCH_COMPUTE_DTYPE", "float32")
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 256, (50, 70, 3), dtype=np.uint8)
              for _ in range(11)]  # ragged count -> padding + sharding

    monkeypatch.setenv("EVOSSEARCH_DP_ENCODE", "True")
    eng_dp = SearchEngine(cfg=Config(env_path=None), spec=tiny, device="cpu")
    assert eng_dp._encode_devices is not None
    emb_dp = eng_dp.encode_images(images)

    monkeypatch.setenv("EVOSSEARCH_DP_ENCODE", "False")
    eng_1d = SearchEngine(cfg=Config(env_path=None), spec=tiny, device="cpu")
    assert eng_1d._encode_devices is None
    emb_1d = eng_1d.encode_images(images)

    assert emb_dp.shape == (11, 32)
    np.testing.assert_allclose(emb_dp, emb_1d, rtol=1e-6, atol=1e-6)
