"""The port against tests/test_legacy_migration.py: migration of
reference-format .clip_index stores (FAISS flat + pickles).

No faiss in this image, so fixtures are synthesized byte-for-byte to the
documented IndexFlat layout (see index/legacy.py) in both the modern
(uint8 code vector) and old (float vector) variants.

Harness only: the engine is made on the CPU.
"""

import pickle
import struct

import numpy as np
import pytest

from evossearch_tpu_torch.index.legacy import migrate_legacy_index, read_faiss_flat
from evossearch_tpu_torch.index.store import IndexReader


def _write_faiss_flat(path, matrix: np.ndarray, layout: str = "codes"):
    d = matrix.shape[1]
    ntotal = matrix.shape[0]
    raw = matrix.astype("<f4").tobytes()
    blob = b"IxFI"
    blob += struct.pack("<i", d)
    blob += struct.pack("<q", ntotal)
    blob += struct.pack("<qq", 1 << 20, 1 << 20)  # dummies
    blob += struct.pack("<B", 1)  # is_trained
    blob += struct.pack("<i", 0)  # metric_type (IP)
    if layout == "codes":  # modern: uint8 vector, count = bytes
        blob += struct.pack("<Q", len(raw)) + raw
    else:  # old: float vector, count = floats
        blob += struct.pack("<Q", ntotal * d) + raw
    path.write_bytes(blob)


def _legacy_dir(tmp_path, n=6, d=32, layout="codes", with_meta=True):
    rng = np.random.default_rng(0)
    matrix = rng.standard_normal((n, d)).astype(np.float32)
    root = tmp_path / ".clip_index"
    root.mkdir()
    _write_faiss_flat(root / "index.faiss", matrix, layout)
    paths = [f"/photos/img_{i}.jpg" for i in range(n)]
    (root / "paths.pkl").write_bytes(pickle.dumps(paths))
    if with_meta:
        meta = [{"path": p, "mtime": float(i), "size": 10 + i}
                for i, p in enumerate(paths)]
        (root / "metadata.pkl").write_bytes(pickle.dumps(meta))
    return matrix, paths


@pytest.mark.parametrize("layout", ["codes", "floats"])
def test_read_faiss_flat(tmp_path, layout):
    matrix, _ = _legacy_dir(tmp_path, layout=layout)
    got = read_faiss_flat(tmp_path / ".clip_index" / "index.faiss")
    np.testing.assert_array_equal(got, matrix)


def test_read_faiss_flat_rejects_garbage(tmp_path):
    f = tmp_path / "x.faiss"
    f.write_bytes(b"garbage bytes here")
    assert read_faiss_flat(f) is None
    _legacy_dir(tmp_path)
    truncated = (tmp_path / ".clip_index" / "index.faiss").read_bytes()[:-8]
    f.write_bytes(truncated)
    assert read_faiss_flat(f) is None


def test_migrate_legacy_index(tmp_path):
    matrix, paths = _legacy_dir(tmp_path)
    count = migrate_legacy_index(tmp_path, model_name="ViT-B/32")
    assert count == 6
    reader = IndexReader.open(tmp_path)
    assert reader is not None and reader.count == 6
    np.testing.assert_array_equal(np.asarray(reader.embeddings()), matrix)
    assert reader.paths == paths
    assert reader.metadata[2]["mtime"] == 2.0
    assert not (tmp_path / ".clip_index" / "index.faiss").exists()


def test_migrate_without_metadata(tmp_path):
    _legacy_dir(tmp_path, with_meta=False)
    assert migrate_legacy_index(tmp_path, model_name="m") == 6
    reader = IndexReader.open(tmp_path)
    assert reader.metadata[0]["mtime"] == 0


def test_migrate_dim_mismatch_refused(tmp_path):
    _legacy_dir(tmp_path, d=32)
    assert migrate_legacy_index(tmp_path, "m", expected_dim=64) is None
    assert (tmp_path / ".clip_index" / "index.faiss").exists()  # untouched


def test_engine_auto_migrates(tmp_path, monkeypatch):
    from evossearch_tpu_torch.core import Config
    from evossearch_tpu_torch.core.constants import CLIPModelSpec
    from evossearch_tpu_torch.engine import SearchEngine

    tiny = CLIPModelSpec(
        name="tiny", image_size=64, patch_size=16, vision_width=64,
        vision_layers=2, vision_heads=4, text_width=48, text_layers=2,
        text_heads=4, vocab_size=49408, context_length=77, embed_dim=32,
    )
    matrix, paths = _legacy_dir(tmp_path, d=32)
    monkeypatch.setenv("EVOSSEARCH_COMPUTE_DTYPE", "float32")
    eng = SearchEngine(cfg=Config(env_path=None), spec=tiny, device="cpu")
    assert eng.is_indexed(str(tmp_path))  # triggers migration
    q = matrix[3] / np.linalg.norm(matrix[3])
    scores, idx, reader = eng.search_embedding(str(tmp_path), q, 3)
    assert reader.paths[int(idx[0])] == paths[3]
