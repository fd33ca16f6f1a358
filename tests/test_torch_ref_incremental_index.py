"""The port against tests/test_incremental_index.py: incremental re-
indexing: unchanged files reuse stored embeddings; new, modified, and
deleted files are handled; results equal a full rebuild.

Harness only: the engines are made on the CPU.
"""

import os
import time

import numpy as np
import pytest
from PIL import Image

from evossearch_tpu_torch.core import Config
from evossearch_tpu_torch.core.constants import CLIPModelSpec
from evossearch_tpu_torch.engine import SearchEngine
from evossearch_tpu_torch.index import IndexReader

TINY = CLIPModelSpec(
    name="tiny", image_size=64, patch_size=16, vision_width=64,
    vision_layers=2, vision_heads=4, text_width=48, text_layers=2,
    text_heads=4, vocab_size=49408, context_length=77, embed_dim=32,
)


@pytest.fixture()
def engine(monkeypatch):
    monkeypatch.setenv("EVOSSEARCH_COMPUTE_DTYPE", "float32")
    return SearchEngine(cfg=Config(env_path=None), spec=TINY, device="cpu")


def _img(rng, path):
    Image.fromarray(
        rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)
    ).save(path, quality=92)


def test_incremental_reuses_and_updates(engine, tmp_path):
    rng = np.random.default_rng(0)
    for i in range(6):
        _img(rng, tmp_path / f"i{i}.jpg")
    assert engine.index_folder(str(tmp_path)) == 6
    r1 = IndexReader.open(tmp_path)
    emb1 = {p: np.asarray(r1.embeddings()[j]) for j, p in enumerate(r1.paths)}

    # mutate the folder: delete one, modify one, add one
    os.remove(tmp_path / "i0.jpg")
    time.sleep(0.02)
    _img(rng, tmp_path / "i1.jpg")  # new content
    _img(rng, tmp_path / "i9.jpg")  # new file

    count = engine.index_folder(str(tmp_path), incremental=True)
    assert count == 6  # 4 reused + modified + new
    r2 = IndexReader.open(tmp_path)
    emb2 = {p: np.asarray(r2.embeddings()[j]) for j, p in enumerate(r2.paths)}

    assert str(tmp_path / "i0.jpg") not in emb2
    assert str(tmp_path / "i9.jpg") in emb2
    # unchanged files carry identical embeddings (bitwise reuse)
    for i in (2, 3, 4, 5):
        p = str(tmp_path / f"i{i}.jpg")
        np.testing.assert_array_equal(emb1[p], emb2[p])
    # modified file re-embedded to a different vector
    p1 = str(tmp_path / "i1.jpg")
    assert not np.array_equal(emb1[p1], emb2[p1])


def test_incremental_equals_full_rebuild(engine, tmp_path):
    rng = np.random.default_rng(1)
    for i in range(5):
        _img(rng, tmp_path / f"x{i}.jpg")
    engine.index_folder(str(tmp_path))
    engine.index_folder(str(tmp_path), incremental=True)
    r = IndexReader.open(tmp_path)
    q = engine.encode_text("anything")
    s_inc, i_inc, _ = engine.search_embedding(str(tmp_path), q, 5)
    engine.index_folder(str(tmp_path), incremental=False)
    s_full, i_full, r_full = engine.search_embedding(str(tmp_path), q, 5)
    # same result content (paths+scores), ordering identical
    paths_inc = [r.paths[int(j)] for j in i_inc]
    paths_full = [r_full.paths[int(j)] for j in i_full]
    assert paths_inc == paths_full
    np.testing.assert_allclose(s_inc, s_full, atol=1e-5)


def test_incremental_on_model_change_rebuilds(engine, tmp_path, monkeypatch):
    rng = np.random.default_rng(2)
    for i in range(3):
        _img(rng, tmp_path / f"y{i}.jpg")
    engine.index_folder(str(tmp_path))
    # different model name in the manifest -> no reuse possible
    other_spec = CLIPModelSpec(**{**TINY.__dict__, "name": "other"})
    monkeypatch.setenv("EVOSSEARCH_COMPUTE_DTYPE", "float32")
    eng2 = SearchEngine(cfg=Config(env_path=None), spec=other_spec, device="cpu")
    assert eng2.index_folder(str(tmp_path), incremental=True) == 3
    assert IndexReader.open(tmp_path).model == "other"
