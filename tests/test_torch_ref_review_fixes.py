"""The port against tests/test_review_fixes.py: regression tests for the
code-review findings (round 1 review).

Harness only: engines are made on the CPU, and params come from the
port's ``init_params`` (a torch seed) through ``params_to_numpy``.
"""

import numpy as np
import pytest
from PIL import Image

from evossearch_tpu_torch.core import Config
from evossearch_tpu_torch.core.constants import CLIPModelSpec
from evossearch_tpu_torch.engine import SearchEngine
from evossearch_tpu_torch.server import TestClient, create_app
from evossearch_tpu_torch.server.web import _parse_multipart

TINY = CLIPModelSpec(
    name="tiny", image_size=64, patch_size=16, vision_width=64,
    vision_layers=2, vision_heads=4, text_width=48, text_layers=2,
    text_heads=4, vocab_size=49408, context_length=77, embed_dim=32,
)


def _client(tmp_path, monkeypatch):
    monkeypatch.setenv("EVOSSEARCH_COMPUTE_DTYPE", "float32")
    monkeypatch.delenv("EVOSSEARCH_CHECKPOINT", raising=False)
    cfg = Config(env_path=None)
    engine = SearchEngine(cfg=cfg, spec=TINY, device="cpu")
    return TestClient(create_app(engine=engine, cfg=cfg))


def test_multipart_preserves_crlf_payload_bytes():
    """Binary payloads beginning/ending with CR/LF must survive parsing."""
    payload = b"\r\n\x00\x01\r\nmiddle\r\n\n\r"
    boundary = b"XBOUND"
    body = (
        b"--XBOUND\r\n"
        b'Content-Disposition: form-data; name="image"; filename="f.bin"\r\n'
        b"Content-Type: application/octet-stream\r\n\r\n"
        + payload
        + b"\r\n--XBOUND--\r\n"
    )
    form, files = _parse_multipart(body, boundary)
    assert files["image"].content == payload


def test_comments_cannot_unlock_image_serving(tmp_path, monkeypatch):
    """A POST /comments on an arbitrary folder must NOT make files in that
    folder servable via /image/ (only a real index with a manifest does)."""
    client = _client(tmp_path, monkeypatch)
    secret_dir = tmp_path / "private"
    secret_dir.mkdir()
    secret = secret_dir / "secret.txt"
    secret.write_text("sensitive")
    r = client.post(
        "/comments",
        json_body={"folder": str(secret_dir), "image_path": "x",
                   "comment": "hi"},
    )
    assert r.status_code == 200  # comments on unindexed folders are allowed
    assert (secret_dir / ".clip_index").exists()  # marker dir got created...
    r = client.get("/image/" + str(secret))
    assert r.status_code == 403  # ...but file serving stays locked


def test_long_query_with_fallback_tokenizer_succeeds(tmp_path, monkeypatch):
    client = _client(tmp_path, monkeypatch)
    rng = np.random.default_rng(0)
    for i in range(3):
        Image.fromarray(
            rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)
        ).save(tmp_path / f"i{i}.jpg")
    assert client.post("/index", json_body={"folder": str(tmp_path)}).status_code == 200
    long_query = "a very long natural language query " * 8  # ~280 bytes
    r = client.post(
        "/search",
        json_body={"folder": str(tmp_path), "query": long_query, "limit": 3},
    )
    assert r.status_code == 200, r.json
    assert len(r.json["results"]) == 3


def test_engine_boots_from_native_npz_checkpoint(tmp_path, monkeypatch):
    from evossearch_tpu_torch.models import init_params, params_to_numpy
    from evossearch_tpu_torch.models.checkpoint import save_params

    params = params_to_numpy(init_params(TINY, seed=7, device="cpu"))
    ckpt = tmp_path / "clip.npz"
    save_params(ckpt, params, TINY)
    monkeypatch.setenv("EVOSSEARCH_CHECKPOINT", str(ckpt))
    monkeypatch.setenv("EVOSSEARCH_COMPUTE_DTYPE", "float32")
    eng = SearchEngine(cfg=Config(env_path=None), device="cpu")
    assert eng.spec == TINY  # spec came from the checkpoint, not CLIP_MODEL
    emb = eng.encode_text("hello")
    assert emb.shape == (TINY.embed_dim,)


def test_shard_size_knob_controls_layout(tmp_path, monkeypatch):
    from evossearch_tpu_torch.index import IndexReader

    rng = np.random.default_rng(1)
    for i in range(5):
        Image.fromarray(
            rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)
        ).save(tmp_path / f"i{i}.jpg")
    monkeypatch.setenv("EVOSSEARCH_COMPUTE_DTYPE", "float32")
    monkeypatch.setenv("EVOSSEARCH_SHARD_SIZE", "2")
    eng = SearchEngine(cfg=Config(env_path=None), spec=TINY, device="cpu")
    assert eng.index_folder(str(tmp_path)) == 5
    reader = IndexReader.open(tmp_path)
    assert len(reader.shard_arrays()) == 3  # 2+2+1 rows


def test_prepare_batch_shape_ladder():
    """Heterogeneous batches must draw from a bounded shape ladder."""
    from evossearch_tpu_torch.preprocess import prepare_batch

    rng = np.random.default_rng(2)
    shapes = set()
    for trial in range(6):
        arrays = [
            rng.integers(0, 256, (rng.integers(50, 500), rng.integers(50, 500), 3),
                         dtype=np.uint8)
            for _ in range(5)
        ]
        c, ah, aw, idx = prepare_batch(arrays, target=224)
        # two-tier ladder: 64-multiples to 512, 128-multiples above
        for dim in (c.shape[1], c.shape[2]):
            assert dim % (64 if dim <= 512 else 128) == 0
        assert ah.shape[0] in (1, 2, 4, 8)  # U padded to power of two
        shapes.add((c.shape[1], c.shape[2], ah.shape[0]))
    assert len(shapes) <= 10  # bounded compile-shape variety
