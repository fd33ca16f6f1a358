"""The port's shard store (bf16 held as uint16 bits, no ml_dtypes)
against the JAX package's: stores written by either open in the other,
byte for byte, in float32 and bfloat16."""

import ml_dtypes
import numpy as np
import pytest
import torch

from evossearch_tpu.index import IndexReader as RefReader
from evossearch_tpu.index import IndexWriter as RefWriter
from evossearch_tpu_torch.index import IndexReader, IndexWriter
from evossearch_tpu_torch.index.store import as_float32, bf16_bits

WRITERS = {"port": IndexWriter, "ref": RefWriter}
READERS = {"port": IndexReader, "ref": RefReader}


def _write(writer_cls, folder, dtype, n=10, dim=8):
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((n, dim)).astype(np.float32)
    paths = [f"/img/{i}.jpg" for i in range(n)]
    meta = [{"path": p, "mtime": float(i), "size": 100 + i}
            for i, p in enumerate(paths)]
    w = writer_cls.create(folder, model="tiny", dim=dim, dtype_name=dtype,
                          rows_per_shard=4)
    for start in range(0, n, 3):
        w.append(emb[start:start + 3], paths[start:start + 3],
                 meta[start:start + 3])
    w.finalize()
    return emb, paths, meta


def _rows_f32(reader) -> np.ndarray:
    rows = np.asarray(reader.embeddings())
    return as_float32(rows) if rows.dtype == np.uint16 else rows.astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("direction", [("ref", "port"), ("port", "ref")])
def test_store_opens_across_packages(direction, dtype, tmp_path):
    writer, reader = direction
    emb, paths, meta = _write(WRITERS[writer], tmp_path / "a", dtype)
    r = READERS[reader].open(tmp_path / "a", verify_checksums=True)
    assert r is not None and r.count == 10 and r.model == "tiny"
    assert r.paths == paths and r.metadata == meta
    want = emb if dtype == "float32" else \
        emb.astype(ml_dtypes.bfloat16).astype(np.float32)
    np.testing.assert_array_equal(_rows_f32(r), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_files_byte_identical(dtype, tmp_path):
    _write(IndexWriter, tmp_path / "p", dtype)
    _write(RefWriter, tmp_path / "r", dtype)
    for shard in sorted((tmp_path / "r" / ".clip_index" / "shards").iterdir()):
        mine = tmp_path / "p" / ".clip_index" / "shards" / shard.name
        assert mine.read_bytes() == shard.read_bytes()
    for name in ("paths.json", "metadata.json"):
        assert (tmp_path / "p" / ".clip_index" / name).read_bytes() == \
            (tmp_path / "r" / ".clip_index" / name).read_bytes()


def test_bf16_rounding_equals_ml_dtypes():
    rng = np.random.default_rng(1)
    x = np.concatenate([
        rng.standard_normal(100_000).astype(np.float32),
        rng.standard_normal(1000).astype(np.float32) * 1e-38,  # subnormals
        np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 3.4028235e38,
                  -3.4028235e38, 1.0 + 2**-8, 1.0 + 3 * 2**-8], np.float32),
        # exact halfway cases between two bf16 values
        (rng.integers(0, 2**16, 1000, dtype=np.uint32) << 16 | 0x8000)
        .astype(np.uint32).view(np.float32),
    ])
    with np.errstate(invalid="ignore"):  # NaN through ml_dtypes' cast
        want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    got = bf16_bits(x)
    finite = np.isfinite(x)
    np.testing.assert_array_equal(got[finite], want[finite])
    np.testing.assert_array_equal(got[~finite & ~np.isnan(x)],
                                  want[~finite & ~np.isnan(x)])
    assert np.isnan(as_float32(got[np.isnan(x)])).all()
    # the bits read by torch as bfloat16 are the same values
    t = torch.from_numpy(got[finite].copy()).view(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(t, want[finite].view(ml_dtypes.bfloat16)
                                  .astype(np.float32))


def test_corrupt_manifest_not_indexed(tmp_path):
    _write(RefWriter, tmp_path, "bfloat16")
    (tmp_path / ".clip_index" / "manifest.json").write_text("{broken")
    assert IndexReader.open(tmp_path) is None


def test_truncated_shard_not_indexed(tmp_path):
    _write(RefWriter, tmp_path, "bfloat16")
    shard = tmp_path / ".clip_index" / "shards" / "emb_00000.bin"
    shard.write_bytes(shard.read_bytes()[:-2])
    assert IndexReader.open(tmp_path) is None


def test_bitrot_caught_by_checksum(tmp_path):
    _write(RefWriter, tmp_path, "float32")
    shard = tmp_path / ".clip_index" / "shards" / "emb_00001.bin"
    raw = bytearray(shard.read_bytes())
    raw[3] ^= 0xFF
    shard.write_bytes(bytes(raw))
    assert IndexReader.open(tmp_path) is not None
    assert IndexReader.open(tmp_path, verify_checksums=True) is None


def test_missing_folder_not_indexed(tmp_path):
    assert IndexReader.open(tmp_path / "nope") is None
