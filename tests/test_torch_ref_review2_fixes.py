"""The port against tests/test_review2_fixes.py: regression tests for
the second (high-effort) code-review findings.

Harness only: engines are made on the CPU; the port's ``decay_mask``
is keyed by parameter name, so the test gathers it by the JAX
package's tree key and holds it against the JAX package's mask.
"""

import numpy as np
import pytest
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

BASE_SETTINGS = {"host": "0.0.0.0", "port": 5000, "debug": False,
                 "clipModel": "ViT-B/32", "minResults": 3, "maxResults": 48,
                 "defaultResults": 12}


def _client(monkeypatch):
    monkeypatch.setenv("EVOSSEARCH_COMPUTE_DTYPE", "float32")
    monkeypatch.delenv("EVOSSEARCH_CHECKPOINT", raising=False)
    cfg = Config(env_path=None)
    return TestClient(create_app(engine=SearchEngine(cfg=cfg, spec=TINY, device="cpu"), cfg=cfg))


def test_image_serving_requires_index_membership(tmp_path, monkeypatch):
    """Indexing a folder must not expose its NON-indexed files (dotfiles,
    configs) through /image/."""
    client = _client(monkeypatch)
    rng = np.random.default_rng(0)
    Image.fromarray(rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)).save(
        tmp_path / "img.jpg"
    )
    secret = tmp_path / "credentials.txt"
    secret.write_text("hunter2")
    assert client.post("/index", json_body={"folder": str(tmp_path)}).json["success"]
    assert client.get("/image/" + str(tmp_path / "img.jpg")).status_code == 200
    assert client.get("/image/" + str(secret)).status_code == 403


def test_settings_preserves_unmanaged_env_keys(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    (tmp_path / ".env").write_text(
        "EVOSSEARCH_CHECKPOINT=/ckpts/clip.npz\nEVOSSEARCH_PORT=5000\n"
    )
    client = _client(monkeypatch)
    r = client.post("/settings", json_body={**BASE_SETTINGS, "port": 7001})
    assert r.status_code == 200, r.json
    from evossearch_tpu_torch.core.config import _parse_env_file

    env = _parse_env_file(tmp_path / ".env")  # parse WITHOUT exporting
    assert env["EVOSSEARCH_PORT"] == "7001"  # managed key updated
    assert env["EVOSSEARCH_CHECKPOINT"] == "/ckpts/clip.npz"  # preserved


def test_settings_rejects_newline_injection(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    client = _client(monkeypatch)
    r = client.post(
        "/settings",
        json_body={**BASE_SETTINGS,
                   "host": "0.0.0.0\nEVOSSEARCH_CHECKPOINT=/tmp/evil"},
    )
    assert r.status_code == 400
    assert "newlines" in r.json["error"]
    assert not (tmp_path / ".env").exists()


def test_decay_mask_excludes_gains_and_biases():
    from evossearch_tpu_torch.models import init_params
    from evossearch_tpu_torch.models.checkpoint import tree_key
    from evossearch_tpu_torch.train.contrastive import decay_mask

    model = init_params(TINY, seed=0, device="cpu")
    by_name = decay_mask(model)
    # the port's mask is by parameter name; gather it by the JAX package's
    # tree key (every layer of a stacked leaf must agree)
    mask = {}
    for name, decays in by_name.items():
        mask.setdefault(tree_key(name)[0], set()).add(decays)
    assert all(len(v) == 1 for v in mask.values()), mask
    mask = {key: v.pop() for key, v in mask.items()}
    assert mask["visual/ln_pre/scale"] is False
    assert mask["visual/ln_pre/bias"] is False
    assert mask["visual/blocks/attn/bqkv"] is False
    assert mask["visual/blocks/attn/wqkv"] is True
    assert mask["visual/blocks/mlp/w1"] is True
    assert mask["logit_scale"] is False
    assert mask["text/token_embed"] is True

    # the JAX package's mask is the oracle, leaf for leaf
    import jax

    from evossearch_tpu.models import init_params as ref_init_params
    from evossearch_tpu.train.contrastive import decay_mask as ref_decay_mask

    ref = ref_decay_mask(ref_init_params(jax.random.key(0), TINY))
    flat = jax.tree_util.tree_flatten_with_path(ref)[0]
    want = {"/".join(k.key for k in path): bool(v) for path, v in flat}
    assert mask == want


def test_interrupted_swap_recovery(tmp_path):
    from evossearch_tpu_torch.index import IndexReader, IndexWriter

    def write(marker):
        w = IndexWriter.create(tmp_path, model="m", dim=4)
        w.append(np.full((2, 4), marker, np.float32), ["a", "b"],
                 [{"path": "a"}, {"path": "b"}])
        w.finalize()

    write(1.0)
    # simulate a crash between finalize's two renames: live moved to .old,
    # staging never promoted
    live = tmp_path / ".clip_index"
    live.rename(tmp_path / ".clip_index.old")
    r = IndexReader.open(tmp_path)  # recovery rolls .old back
    assert r is not None and r.count == 2
    assert float(np.asarray(r.embeddings())[0, 0]) == 1.0

    # second shape: fully-written staging dir, live missing -> promote tmp
    import shutil

    live.rename(tmp_path / ".clip_index.tmp")
    r = IndexReader.open(tmp_path)
    assert r is not None and r.count == 2


def test_empty_folder_leaves_no_staging_litter(tmp_path, monkeypatch):
    monkeypatch.setenv("EVOSSEARCH_COMPUTE_DTYPE", "float32")
    eng = SearchEngine(cfg=Config(env_path=None), spec=TINY, device="cpu")
    assert eng.index_folder(str(tmp_path)) == 0
    assert list(tmp_path.iterdir()) == []  # no .clip_index.tmp left behind
