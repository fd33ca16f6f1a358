"""Migration from the reference's legacy `.clip_index` store.

The reference persists `index.faiss` (FAISS IndexFlat binary) plus
`paths.pkl` / `metadata.pkl` pickles (oldapp.py:92-106). A user switching
to this framework keeps their embeddings: `migrate_legacy_index` parses the
FAISS flat file directly (no faiss dependency) and republishes the data in
our shard format — no re-embedding.

FAISS IndexFlat on-disk layout (faiss index_write.cpp, v1.7.x):
    fourcc:      4 bytes, "IxFI" (inner product) / "IxF2" (L2) / "IxFl"
    d:           int32
    ntotal:      int64
    2 x dummy:   int64 each
    is_trained:  1 byte
    metric_type: int32
    codes:       uint64 element count, then raw data — newer releases
                 store a uint8 code vector (count == ntotal*d*4), old ones
                 a float32 vector (count == ntotal*d)

Every field is validated against the file size; any anomaly aborts the
migration (None), leaving the legacy files untouched.
"""

from __future__ import annotations

import pickle
import struct
from pathlib import Path

import numpy as np

from ..utils import get_logger
from .store import IndexWriter, index_dir

log = get_logger("index.legacy")

_FOURCC = (b"IxFI", b"IxF2", b"IxFl")


def read_faiss_flat(path: str | Path) -> np.ndarray | None:
    """Parse a FAISS IndexFlat file -> (N, d) float32 matrix, or None."""
    try:
        raw = Path(path).read_bytes()
        if len(raw) < 33 or raw[:4] not in _FOURCC:
            return None
        d = struct.unpack_from("<i", raw, 4)[0]
        ntotal = struct.unpack_from("<q", raw, 8)[0]
        # skip 2 dummy int64 (16 bytes) + is_trained (1) + metric (4)
        offset = 4 + 4 + 8 + 16 + 1 + 4
        if not (0 < d <= 1 << 14) or not (0 <= ntotal <= 1 << 40):
            return None
        count = struct.unpack_from("<Q", raw, offset)[0]
        offset += 8
        if count == ntotal * d * 4:  # uint8 code vector (modern layout)
            nbytes = count
        elif count == ntotal * d:  # float vector (old layout)
            nbytes = count * 4
        else:
            return None
        if offset + nbytes > len(raw):
            return None
        return (
            np.frombuffer(raw, np.float32, count=ntotal * d, offset=offset)
            .reshape(ntotal, d)
            .copy()
        )
    except Exception:
        return None


def migrate_legacy_index(
    folder: str | Path,
    model_name: str,
    expected_dim: int | None = None,
    index_folder_name: str = ".clip_index",
) -> int | None:
    """Convert a reference-format index dir in place; returns the row count,
    or None when no (valid) legacy index exists."""
    root = index_dir(folder, index_folder_name)
    faiss_file = root / "index.faiss"
    paths_file = root / "paths.pkl"
    if not faiss_file.exists() or not paths_file.exists():
        return None
    matrix = read_faiss_flat(faiss_file)
    if matrix is None:
        log.warning("legacy index.faiss in %s is unreadable; not migrating", root)
        return None
    if expected_dim is not None and matrix.shape[1] != expected_dim:
        log.warning(
            "legacy index dim %d != model dim %d; not migrating",
            matrix.shape[1], expected_dim,
        )
        return None
    try:
        paths = pickle.loads(paths_file.read_bytes())
        if not isinstance(paths, list) or len(paths) != matrix.shape[0]:
            return None
        metadata = None
        meta_file = root / "metadata.pkl"
        if meta_file.exists():
            try:
                metadata = pickle.loads(meta_file.read_bytes())
                # entry SHAPE must hold too, not just the length:
                # downstream subscripts m["path"]/m["mtime"]/m["size"]
                # (builder._reuse_unchanged_rows, __main__'s watch
                # fingerprint), and a migrated-verbatim list of tuples
                # would crash those with a 500 instead of the store
                # invariant's "malformed -> treat as absent"
                if not (
                    isinstance(metadata, list)
                    and len(metadata) == len(paths)
                    and all(
                        isinstance(m, dict)
                        and {"path", "mtime", "size"} <= m.keys()
                        for m in metadata
                    )
                ):
                    metadata = None
            except Exception:
                metadata = None
        if metadata is None:  # synthesize (metadata optional in reference)
            metadata = [{"path": str(p), "mtime": 0, "size": 0} for p in paths]
    except Exception:
        return None

    writer = IndexWriter.create(
        folder, model=model_name, dim=matrix.shape[1],
        index_folder_name=index_folder_name,
    )
    writer.append(matrix, [str(p) for p in paths], metadata)
    writer.finalize()
    log.info("migrated legacy FAISS index in %s: %d rows", root, len(paths))
    return len(paths)
