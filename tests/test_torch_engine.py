"""The slice end to end on the CPU: the port's engine and HTTP app
against the JAX package's, from the same npz checkpoint (a tiny spec,
float32 compute and store so the rankings compare exactly; embeddings
within 1e-4, the preprocess's 1-LSB round-half flips included)."""

import base64
import io
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from evossearch_tpu.core import Config as RefConfig
from evossearch_tpu.core.constants import CLIPModelSpec
from evossearch_tpu.engine import SearchEngine as RefEngine
from evossearch_tpu.index import IndexReader as RefReader
from evossearch_tpu.models import init_params
from evossearch_tpu.models.checkpoint import save_params
from evossearch_tpu_torch.core import Config
from evossearch_tpu_torch.engine import SearchEngine
from evossearch_tpu_torch.index import IndexReader
from evossearch_tpu_torch.server import TestClient, create_app

TINY = CLIPModelSpec(
    name="tiny", image_size=64, patch_size=16, vision_width=64,
    vision_layers=2, vision_heads=4, text_width=48, text_layers=2,
    text_heads=4, vocab_size=49408, context_length=77, embed_dim=32,
)
EMB_ATOL = 1e-4


def _configs(tmp, ckpt, **extra):
    """(port Config, reference Config) from one EVOSSEARCH_* environment;
    the process environment is restored afterwards (other test files on
    the same worker read it)."""
    saved = dict(os.environ)
    try:
        for key in list(os.environ):
            if key.startswith("EVOSSEARCH_"):
                del os.environ[key]
        os.environ.update({
            "EVOSSEARCH_COMPUTE_DTYPE": "float32",
            "EVOSSEARCH_STORE_DTYPE": "float32",
            "EVOSSEARCH_BATCH_SIZE": "4",
            "EVOSSEARCH_FAST_DECODE": "0",
            "EVOSSEARCH_CHECKPOINT": str(ckpt),
            **extra,
        })
        env = tmp / "missing.env"
        return Config(env_path=env), RefConfig(env_path=env)
    finally:
        os.environ.clear()
        os.environ.update(saved)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Two copies of one fixture folder, indexed by each package."""
    root = tmp_path_factory.mktemp("engines")
    ckpt = save_params(root / "tiny.npz", init_params(jax.random.key(5), TINY), TINY)
    rng = np.random.default_rng(0)
    sizes = [(80, 100), (120, 90), (64, 64), (50, 400), (200, 150), (96, 128)]
    arrays = [rng.integers(0, 256, hw + (3,), dtype=np.uint8) for hw in sizes]
    folders = {}
    for name in ("port", "ref"):
        folder = root / name
        folder.mkdir()
        for i, arr in enumerate(arrays):
            Image.fromarray(arr).save(folder / f"img_{i}.jpg", quality=90)
        Image.fromarray(arrays[0]).save(folder / "img_6.png")
        folders[name] = folder
    cfg, ref_cfg = _configs(root, ckpt)
    port = SearchEngine(cfg=cfg, device="cpu")
    ref = RefEngine(cfg=ref_cfg)
    assert port.index_folder(str(folders["port"])) == 7
    assert ref.index_folder(str(folders["ref"])) == 7
    yield port, ref, folders, ckpt, arrays
    port.close()
    ref.close()


def _rel(paths, folder):
    return [os.path.relpath(p, folder) for p in paths]


def test_index_paths_metadata_and_embeddings(setup):
    port, _, folders, _, _ = setup
    a = IndexReader.open(folders["port"])
    b = RefReader.open(folders["ref"])
    assert _rel(a.paths, folders["port"]) == _rel(b.paths, folders["ref"])
    assert [(m["size"]) for m in a.metadata] == [m["size"] for m in b.metadata]
    assert a.model == b.model == "tiny" and a.dtype_name == b.dtype_name
    np.testing.assert_allclose(np.asarray(a.embeddings()),
                               np.asarray(b.embeddings()), rtol=0, atol=EMB_ATOL)


@pytest.mark.parametrize("k", [1, 3, 7])
def test_text_queries_same_ids(setup, k):
    port, ref, folders, _, _ = setup
    for text in ("a photo of a cat", "red", "東京 café 2024"):
        got = port.search_text(str(folders["port"]), text, k)
        want = ref.search_text(str(folders["ref"]), text, k)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=EMB_ATOL)


def test_embedding_and_image_queries_same_ids(setup):
    port, ref, folders, _, arrays = setup
    q = np.random.default_rng(3).standard_normal(TINY.embed_dim).astype(np.float32)
    q /= np.linalg.norm(q)
    got = port.search_embedding(str(folders["port"]), q, 5)
    want = ref.search_embedding(str(folders["ref"]), q, 5)
    np.testing.assert_array_equal(got[1], want[1])
    for arr in arrays[:3]:
        got = port.search_image(str(folders["port"]), Image.fromarray(arr), 4)
        want = ref.search_image(str(folders["ref"]), Image.fromarray(arr), 4)
        np.testing.assert_array_equal(got[1], want[1])
    emb = port.encode_images(arrays[:2])
    np.testing.assert_allclose(emb, ref.encode_images(arrays[:2]), atol=EMB_ATOL)


def test_stored_embedding_and_membership(setup):
    port, _, folders, _, _ = setup
    folder = str(folders["port"])
    target = str(folders["port"] / "img_2.jpg")
    row = port.stored_embedding(folder, target)
    reader = IndexReader.open(folder)
    np.testing.assert_array_equal(row, np.asarray(reader.embeddings())[2])
    assert port.index_contains(folder, target)
    assert not port.index_contains(folder, str(folders["port"] / "nope.jpg"))
    assert port.is_indexed(folder) and port.is_indexed_fast(folder)


def test_bf16_store_search_matches_reference(setup, tmp_path):
    _, _, folders, ckpt, _ = setup
    cfg, ref_cfg = _configs(tmp_path, ckpt, EVOSSEARCH_STORE_DTYPE="bfloat16",
                            EVOSSEARCH_MICROBATCH_MS="0")
    port = SearchEngine(cfg=cfg, device="cpu")
    ref = RefEngine(cfg=ref_cfg)
    folder = tmp_path / "f"
    folder.mkdir()
    for p in sorted(folders["port"].glob("img_*"))[:5]:
        (folder / p.name).write_bytes(p.read_bytes())
    assert ref.index_folder(str(folder)) == 5  # the JAX package's bf16 store
    got = port.search_text(str(folder), "a photo", 5)
    want = ref.search_text(str(folder), "a photo", 5)
    np.testing.assert_array_equal(got[1], want[1])
    port.close()
    ref.close()


def test_over_budget_folder_takes_host_scan(setup, tmp_path):
    _, _, folders, ckpt, _ = setup
    cfg, _ = _configs(tmp_path, ckpt, EVOSSEARCH_SQ8="off")
    port = SearchEngine(cfg=cfg, device="cpu")
    port.__dict__["_hbm_budget"] = 16  # bytes: no corpus fits
    folder = str(folders["port"])
    got = port.search_text(folder, "a photo of a cat", 3)
    assert port.counters.snapshot()["host_routed_queries"] >= 1
    q = port.encode_text("a photo of a cat")
    reader = IndexReader.open(folder)
    scores = np.asarray(reader.embeddings()) @ q
    want = np.lexsort((np.arange(7), -scores))[:3]
    np.testing.assert_array_equal(got[1], want)
    port.close()
    # under the default EVOSSEARCH_SQ8=auto the tier needs d % 128 == 0;
    # at d = 32 the host scan serves, as in the reference
    sq8 = SearchEngine(cfg=_configs(tmp_path, ckpt)[0], device="cpu")
    sq8.__dict__["_hbm_budget"] = 16
    assert sq8.cfg.SQ8 == "auto"
    s, i = sq8._execute_search_batch(folder, q[None], 3)
    np.testing.assert_array_equal(i[0], want)
    np.testing.assert_allclose(s[0], scores[want], rtol=0, atol=1e-6)
    entry, _ = sq8._cached_index(folder)
    assert entry["sq8"] is None and entry.get("device_bytes", 0) == 0
    snap = sq8.counters.snapshot()
    assert snap["host_routed_queries"] == 1 and "sq8_queries" not in snap
    sq8.close()


@pytest.mark.parametrize("env,item", [
    # the mesh-sharded IVF (parallel/sharded_ivf.py); IVF on one device is
    # ported (tests/test_torch_ivf.py)
    ({"EVOSSEARCH_INDEX_KIND": "ivf", "EVOSSEARCH_SEARCH_KERNEL": "sharded"}, "A13"),
    ({"EVOSSEARCH_SEARCH_KERNEL": "sharded"}, "A13"),
])
def test_unported_tiers_raise(env, item, tmp_path):
    cfg, _ = _configs(tmp_path, "", **env)
    with pytest.raises(NotImplementedError, match=item):
        SearchEngine(cfg=cfg, spec=TINY, device="cpu")


def test_no_gpu_needs_explicit_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    cfg, _ = _configs(tmp_path, "")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SearchEngine(cfg=cfg, spec=TINY)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_app(cfg=cfg)


# -- the /index, /search and /search_by_image scenarios of
#    tests/test_api_contract.py, through the port's app --


@pytest.fixture(scope="module")
def client(setup, tmp_path_factory):
    _, _, folders, ckpt, _ = setup
    tmp = tmp_path_factory.mktemp("api")
    cfg, _ = _configs(tmp, ckpt)
    app = create_app(cfg=cfg, device="cpu")
    assert app.engine.device.type == "cpu"
    c = TestClient(app)
    r = c.post("/index", json_body={"folder": str(folders["port"])})
    assert r.status_code == 200 and r.json == {"success": True, "count": 7}
    yield c, str(folders["port"])
    app.engine.close()


def _jpeg_bytes(seed=0):
    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(seed).integers(
        0, 256, (64, 64, 3), dtype=np.uint8)).save(buf, "JPEG")
    return buf.getvalue()


def test_api_index_errors(client, tmp_path):
    c, _ = client
    r = c.post("/index", json_body={"folder": "/definitely/not/here"})
    assert r.status_code == 400 and r.json["error"] == "Invalid folder path"
    r = c.post("/index", json_body={"folder": str(tmp_path)})
    assert r.status_code == 400 and r.json["error"] == "No images found in folder"
    r = c.post("/check_index", json_body={"folder": str(tmp_path)})
    assert r.json == {"indexed": False}


def test_api_search_contract(client, tmp_path):
    c, folder = client
    r = c.post("/search", json_body={"folder": folder, "query": "a photo", "limit": 3})
    assert r.status_code == 200
    results = r.json["results"]
    assert len(results) == 3
    prev = float("inf")
    for item in results:
        assert set(item) == {"path", "filename", "similarity", "thumbnail", "metadata"}
        assert set(item["metadata"]) == {"mtime", "size"}
        img = Image.open(io.BytesIO(base64.b64decode(item["thumbnail"])))
        assert img.format == "JPEG"
        assert item["similarity"] <= prev + 1e-6
        prev = item["similarity"]
    r = c.post("/search", json_body={"folder": folder})
    assert r.status_code == 400 and r.json["error"] == "Missing folder or query"
    r = c.post("/search", json_body={"folder": str(tmp_path), "query": "x"})
    assert r.status_code == 400
    for bad in (0, 1000, "abc"):
        r = c.post("/search", json_body={"folder": folder, "query": "x", "limit": bad})
        assert len(r.json["results"]) == 7  # DEFAULT_RESULTS 12, 7 rows indexed


def test_api_search_by_image(client):
    c, folder = client
    r = c.post("/search_by_image", data={"folder": folder, "limit": "3"},
               files={"image": ("query.jpg", _jpeg_bytes())})
    assert r.status_code == 200 and len(r.json["results"]) == 3
    target = os.path.join(folder, "img_2.jpg")
    r = c.post("/search_by_image",
               data={"folder": folder, "image_path": target, "limit": "3"})
    assert r.status_code == 200
    assert r.json["results"][0]["path"] == target
    assert r.json["results"][0]["similarity"] > 0.999
    r = c.post("/search_by_image", data={"folder": folder})
    assert r.status_code == 400
    r = c.post("/search_by_image", data={"folder": folder, "image_path": "/nope.jpg"})
    assert r.status_code == 400
