"""The port's HTTP API contract: tests/test_api_contract.py held against
evossearch_tpu_torch, every route and quirk from SURVEY.md §2-K (reference
oldapp.py:188-2258), via the in-process test client.

Every test runs on the CPU and, marked ``gpu``, on the card (the ``device``
fixture; the card case skips in its body without one). Only the harness
differs from the JAX file: the engine is given its device, and each device
gets its own fixture folder. The file imports neither JAX nor the JAX
package, so it also collects on a GPU machine without them."""

import base64
import io
import json

import numpy as np
import pytest
import torch
from PIL import Image

from evossearch_tpu_torch.core import Config
from evossearch_tpu_torch.core.constants import CLIPModelSpec
from evossearch_tpu_torch.engine import SearchEngine
from evossearch_tpu_torch.server import TestClient, create_app

TINY = CLIPModelSpec(
    name="tiny", image_size=64, patch_size=16, vision_width=64,
    vision_layers=2, vision_heads=4, text_width=48, text_layers=2,
    text_heads=4, vocab_size=49408, context_length=77, embed_dim=32,
)


@pytest.fixture(scope="module",
                params=["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return request.param


@pytest.fixture(scope="module")
def fixture_folder(tmp_path_factory, device):
    folder = tmp_path_factory.mktemp(f"imgs_{device}")
    rng = np.random.default_rng(0)
    for i in range(6):
        arr = rng.integers(0, 256, (80, 100, 3), dtype=np.uint8)
        img = Image.fromarray(arr)
        img.save(folder / f"img_{i}.jpg", quality=90)
    return folder


@pytest.fixture(scope="module")
def client(fixture_folder, tmp_path_factory, device):
    import os

    for k in list(os.environ):
        if k.startswith("EVOSSEARCH_"):
            del os.environ[k]
    os.environ["EVOSSEARCH_COMPUTE_DTYPE"] = "float32"
    os.environ["EVOSSEARCH_BATCH_SIZE"] = "4"
    cfg = Config(env_path=tmp_path_factory.mktemp("cfg") / "missing.env")
    engine = SearchEngine(cfg=cfg, spec=TINY, device=device)
    app = create_app(engine=engine, cfg=cfg)
    client = TestClient(app)
    r = client.post("/index", json_body={"folder": str(fixture_folder)})
    assert r.status_code == 200 and r.json["success"], r.json
    return client


# ---- GET / ----

def test_home_page(client):
    r = client.get("/")
    assert r.status_code == 200
    html = r.data.decode()
    assert r.headers["Cache-Control"] == "no-cache, no-store, must-revalidate"
    assert r.headers["Pragma"] == "no-cache"
    assert r.headers["Expires"] == "0"
    # default config: min 3, default 12 (selected), max 48, plus 6/18/24/30
    for v in (3, 6, 12, 18, 24, 30, 48):
        assert f'<option value="{v}"' in html
    assert '<option value="12" selected>' in html


def test_cors_headers(client):
    r = client.get("/")
    assert r.headers["Access-Control-Allow-Origin"] == "*"


# ---- /check_index, /index ----

def test_check_index(client, fixture_folder, tmp_path):
    r = client.post("/check_index", json_body={"folder": str(fixture_folder)})
    assert r.status_code == 200 and r.json == {"indexed": True}
    r = client.post("/check_index", json_body={"folder": str(tmp_path)})
    assert r.json == {"indexed": False}
    r = client.post("/check_index", json_body={})
    assert r.status_code == 400 and r.json["error"] == "No folder specified"


def test_index_invalid_folder(client):
    r = client.post("/index", json_body={"folder": "/definitely/not/here"})
    assert r.status_code == 400 and r.json["error"] == "Invalid folder path"
    r = client.post("/index", json_body={})
    assert r.status_code == 400


def test_index_folder_without_images(client, tmp_path):
    r = client.post("/index", json_body={"folder": str(tmp_path)})
    assert r.status_code == 400
    assert r.json["error"] == "No images found in folder"


# ---- /search ----

def test_search_contract(client, fixture_folder):
    r = client.post(
        "/search",
        json_body={"folder": str(fixture_folder), "query": "a photo", "limit": 3},
    )
    assert r.status_code == 200
    results = r.json["results"]
    assert len(results) == 3
    prev = float("inf")
    for item in results:
        assert set(item) == {"path", "filename", "similarity", "thumbnail", "metadata"}
        assert set(item["metadata"]) == {"mtime", "size"}
        # thumbnail is valid base64 JPEG
        img = Image.open(io.BytesIO(base64.b64decode(item["thumbnail"])))
        assert img.format == "JPEG"
        assert item["similarity"] <= prev + 1e-6
        prev = item["similarity"]


def test_search_missing_fields(client, fixture_folder):
    r = client.post("/search", json_body={"folder": str(fixture_folder)})
    assert r.status_code == 400 and r.json["error"] == "Missing folder or query"
    r = client.post("/search", json_body={"query": "x"})
    assert r.status_code == 400


def test_search_unindexed(client, tmp_path):
    r = client.post("/search", json_body={"folder": str(tmp_path), "query": "x"})
    assert r.status_code == 400 and r.json["error"] == "Folder not indexed"


def test_search_limit_clamping(client, fixture_folder):
    # out-of-range and garbage limits fall back to DEFAULT_RESULTS (12),
    # then k = min(limit, n) = 6 images
    for bad in (0, 100, "nonsense", None):
        r = client.post(
            "/search",
            json_body={"folder": str(fixture_folder), "query": "x", "limit": bad},
        )
        assert r.status_code == 200
        assert len(r.json["results"]) == 6  # clamped to corpus size


def test_search_sort_by_time(client, fixture_folder):
    r = client.post(
        "/search",
        json_body={"folder": str(fixture_folder), "query": "x", "limit": 4,
                   "sort_by": "time"},
    )
    mtimes = [item["metadata"]["mtime"] for item in r.json["results"]]
    assert mtimes == sorted(mtimes, reverse=True)


# ---- /search_by_image ----

def _jpeg_bytes(seed=0):
    rng = np.random.default_rng(seed)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)).save(
        buf, "JPEG"
    )
    return buf.getvalue()


def test_search_by_image_upload(client, fixture_folder):
    r = client.post(
        "/search_by_image",
        data={"folder": str(fixture_folder), "limit": "3"},
        files={"image": ("query.jpg", _jpeg_bytes())},
    )
    assert r.status_code == 200
    assert len(r.json["results"]) == 3
    assert "similarity" in r.json["results"][0]


def test_search_by_image_path_variant(client, fixture_folder):
    target = str(sorted(fixture_folder.glob("*.jpg"))[2])
    r = client.post(
        "/search_by_image",
        data={"folder": str(fixture_folder), "image_path": target, "limit": "3"},
    )
    assert r.status_code == 200
    # find-similar via stored image: top hit is the image itself
    assert r.json["results"][0]["path"] == target
    assert r.json["results"][0]["similarity"] > 0.99


def test_search_by_image_file_wins_over_path(client, fixture_folder):
    target = str(sorted(fixture_folder.glob("*.jpg"))[0])
    r = client.post(
        "/search_by_image",
        data={"folder": str(fixture_folder), "image_path": "/nonexistent.jpg"},
        files={"image": ("q.jpg", _jpeg_bytes())},
    )
    assert r.status_code == 200  # file branch taken; bad path ignored


def test_search_by_image_missing_both(client, fixture_folder):
    r = client.post("/search_by_image", data={"folder": str(fixture_folder)})
    assert r.status_code == 400
    assert r.json["error"] == "No image uploaded or path provided"


def test_search_by_image_bad_path(client, fixture_folder):
    r = client.post(
        "/search_by_image",
        data={"folder": str(fixture_folder), "image_path": "/nope.jpg"},
    )
    assert r.status_code == 400
    assert r.json["error"].startswith("Image file not found")


def test_search_by_image_missing_folder(client):
    r = client.post("/search_by_image", data={"limit": "3"})
    assert r.status_code == 400 and r.json["error"] == "Missing folder"


# ---- /image/ ----

def test_image_serving_absolute_path(client, fixture_folder):
    # Linux absolute paths work (deliberate fix of the reference's 403 quirk)
    target = str(sorted(fixture_folder.glob("*.jpg"))[0])
    r = client.get("/image/" + target)
    assert r.status_code == 200
    assert Image.open(io.BytesIO(r.data)).format == "JPEG"


def test_image_serving_traversal_rejected(client):
    r = client.get("/image/../../etc/passwd")
    assert r.status_code == 403


def test_image_serving_unindexed_folder_rejected(client):
    # files outside indexed folders are not served (traversal protection)
    r = client.get("/image//etc/hostname")
    assert r.status_code in (403, 404)


def test_image_serving_missing(client, fixture_folder):
    r = client.get(f"/image/{fixture_folder}/nope.jpg")
    assert r.status_code == 404


# ---- /comments, /commented_images ----

def test_comments_roundtrip(client, fixture_folder):
    target = str(sorted(fixture_folder.glob("*.jpg"))[1])
    r = client.get(
        f"/comments?folder={fixture_folder}&image_path={target}"
    )
    assert r.status_code == 200 and r.json == {"comments": []}

    r = client.post(
        "/comments",
        json_body={"folder": str(fixture_folder), "image_path": target,
                   "comment": "nice shot"},
    )
    assert r.status_code == 200 and r.json["success"]
    assert len(r.json["comments"]) == 1
    # server-side timestamp prefix format [YYYY-MM-DD HH:MM:SS]
    import re

    assert re.match(r"^\[\d{4}-\d{2}-\d{2} \d{2}:\d{2}:\d{2}\] nice shot$",
                    r.json["comments"][0])


def test_comment_validation(client, fixture_folder):
    r = client.post("/comments", json_body={"folder": str(fixture_folder)})
    assert r.status_code == 400
    r = client.post(
        "/comments",
        json_body={"folder": str(fixture_folder), "image_path": "x",
                   "comment": "y" * 200},
    )
    assert r.status_code == 400
    assert "Comment too long (max 100 characters)" in r.json["error"]


def test_commented_images(client, fixture_folder):
    target = str(sorted(fixture_folder.glob("*.jpg"))[1])
    r = client.post("/commented_images", json_body={"folder": str(fixture_folder)})
    assert r.status_code == 200
    results = r.json["results"]
    assert len(results) == 1
    item = results[0]
    assert set(item) == {"path", "filename", "thumbnail", "comment_count",
                         "latest_comment", "metadata"}
    assert item["path"] == target and item["comment_count"] >= 1

    r = client.post("/commented_images", json_body={})
    assert r.status_code == 400 and r.json["error"] == "No folder specified"

    r = client.post("/commented_images", json_body={"folder": "/not/indexed"})
    assert r.status_code == 400 and r.json["error"] == "Folder not indexed"


# ---- /settings ----

def test_settings_get(client):
    r = client.get("/settings")
    assert r.status_code == 200 and r.json["success"]
    s = r.json["settings"]
    assert set(s) == {
        "host", "port", "debug", "clipModel", "minResults", "maxResults",
        "defaultResults", "batchSize", "thumbnailQuality", "maxCommentLength",
        "maxFileSize", "indexFolderName",
    }
    assert s["port"] == 5000 and s["clipModel"] == "ViT-B/32"


def test_settings_post_validation(client):
    base = {"host": "0.0.0.0", "port": 5000, "debug": False,
            "clipModel": "ViT-B/32", "minResults": 3, "maxResults": 48,
            "defaultResults": 12}
    r = client.post("/settings", json_body={**base, "port": 80})
    assert r.status_code == 400
    assert r.json["error"] == "Port must be between 1000 and 65535"
    r = client.post("/settings", json_body={**base, "minResults": 50})
    assert r.status_code == 400
    assert "Min results" in r.json["error"]
    r = client.post("/settings", json_body={**base, "defaultResults": 2})
    assert r.status_code == 400
    assert "Default results" in r.json["error"]
    del base["host"]
    r = client.post("/settings", json_body=base)
    assert r.status_code == 400
    assert r.json["error"] == "Missing required field: host"


def test_settings_post_writes_env(client, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    body = {"host": "127.0.0.1", "port": 7788, "debug": True,
            "clipModel": "ViT-B/16", "minResults": 2, "maxResults": 20,
            "defaultResults": 8}
    r = client.post("/settings", json_body=body)
    assert r.status_code == 200 and r.json["success"]
    assert "Restart the server" in r.json["message"]
    env = (tmp_path / ".env").read_text()
    assert "EVOSSEARCH_PORT=7788" in env
    assert "EVOSSEARCH_DEBUG=true" in env
    assert "EVOSSEARCH_CLIP_MODEL=ViT-B/16" in env


# ---- misc framework behavior ----

def test_unknown_route_404(client):
    assert client.get("/nope").status_code == 404


def test_method_not_allowed(client):
    assert client.get("/index").status_code == 405


def test_malformed_json_400(client):
    r = client.post("/search", body=b"{not json", content_type="application/json")
    assert r.status_code == 400


def test_stats_endpoint(client):
    r = client.get("/stats")
    assert r.status_code == 200
    assert "counters" in r.json and "stage_timers" in r.json


def test_find_similar_short_circuits_to_stored_embedding(
    client, fixture_folder, monkeypatch
):
    """Path-variant queries for indexed unchanged files must use the
    stored row (no re-encode dispatch); modified files must re-encode."""
    target = str(sorted(fixture_folder.glob("*.jpg"))[1])
    engine = client.app.engine

    def boom(images):  # pragma: no cover - failure path
        raise AssertionError("encode dispatched for an indexed file")

    monkeypatch.setattr(engine, "encode_image_device", boom)
    r = client.post(
        "/search_by_image",
        data={"folder": str(fixture_folder), "image_path": target, "limit": "3"},
    )
    assert r.status_code == 200
    assert r.json["results"][0]["path"] == target
    assert r.json["results"][0]["similarity"] > 0.99
    monkeypatch.undo()

    # touching the file invalidates the short-circuit -> re-encode path
    import os
    os.utime(target, (1, 1))
    called = {}
    real = type(engine).encode_image_device

    def spy(img):
        called["yes"] = True
        return real(engine, img)

    monkeypatch.setattr(engine, "encode_image_device", spy)
    r = client.post(
        "/search_by_image",
        data={"folder": str(fixture_folder), "image_path": target, "limit": "3"},
    )
    assert r.status_code == 200 and called.get("yes")
