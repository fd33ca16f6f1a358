"""Memory-mapped embedding shard store — replaces the reference's
`.clip_index/{index.faiss, paths.pkl, metadata.pkl}` persistence
(oldapp.py:92-135) with a TPU-friendly format:

  <folder>/.clip_index/
      manifest.json          # version, model, dim, dtype, row count,
                             # shard list with per-shard CRC32 checksums
      shards/emb_00000.bin   # raw row-major embedding matrix chunks
      paths.json             # image paths, row-aligned with the matrix
      metadata.json          # [{path, mtime, size}] row-aligned
      comments.json          # comment store (component G), managed elsewhere

Embeddings are stored float32 (or bfloat16, held as uint16 bits) and read back with
``np.memmap`` — zero-copy host access, sliced directly into device transfers
for sharded search. Shards are fixed-row chunks so a 10M-vector corpus maps
onto a device mesh without rewriting files.

Fault tolerance mirrors the reference exactly: ANY error while loading
(missing dir, corrupt file, bad checksum) -> "not indexed" (None), and
metadata remains optional (oldapp.py:108-135). Writes are atomic at the
directory level: new content is staged in ``.clip_index.tmp`` and swapped in
with two renames, so a crashed indexing run never corrupts a live index.
Partial progress for resumable indexing is kept in ``progress.json``.
"""

from __future__ import annotations

import json
import os
import shutil
import zlib
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

FORMAT_VERSION = 1
DEFAULT_ROWS_PER_SHARD = 1 << 18  # 256k rows/shard = 512 MB at d=512 f32


def _dtype_of(name: str):
    """numpy dtype a store's rows are held in. bfloat16 rows are held as
    their uint16 bit patterns (numpy has no bfloat16): the file bytes are
    the same, and ``as_float32`` / ``torch.Tensor.view(torch.bfloat16)``
    read them."""
    if name == "float32":
        return np.float32
    if name == "bfloat16":
        return np.uint16
    raise ValueError(f"unsupported store dtype: {name}")


def bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 bit patterns (uint16), rounded to nearest even;
    NaN stays a quiet NaN of the same sign."""
    x = np.ascontiguousarray(x, np.float32)
    u = x.view(np.uint32)
    bits = ((u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))) >> 16)
    bits = np.where(np.isnan(x), (u >> 16) | np.uint32(0x40), bits)
    return bits.astype(np.uint16)


def as_float32(rows: np.ndarray) -> np.ndarray:
    """Store rows (float32, or bfloat16 bits as uint16) widened exactly to
    float32."""
    if rows.dtype == np.uint16:
        return (np.asarray(rows).astype(np.uint32) << 16).view(np.float32)
    return np.asarray(rows, np.float32)


def _to_storage(embeddings: np.ndarray, dtype_name: str) -> np.ndarray:
    """Rows as the store holds them; bfloat16 rows may arrive as their bit
    patterns (uint16), which pass through unchanged."""
    if dtype_name == "bfloat16":
        return embeddings if embeddings.dtype == np.uint16 else bf16_bits(embeddings)
    return embeddings.astype(_dtype_of(dtype_name))


def index_dir(folder: str | os.PathLike, index_folder_name: str = ".clip_index") -> Path:
    return Path(folder) / index_folder_name


def _recover_interrupted_swap(final_root: Path) -> None:
    """Complete or roll back a publish interrupted between its two renames.

    finalize()'s swap is two renames (live -> .old, staging -> live); a
    crash in between leaves no live dir. Recovery: a staging dir that
    already has its manifest was fully written — promote it; otherwise
    restore the saved .old. Without this, the next finalize() would rmtree
    the .old that holds the only surviving copy.

    Recovery runs under the same cross-process lock finalize() holds for
    the swap, so a concurrent open() during a LIVE publish cannot mistake
    the mid-swap state for a crash and promote the staging dir out from
    under finalize. The lock is only taken when recovery actually looks
    necessary — the common open() of a healthy or never-indexed folder
    must not create lock files in arbitrary (possibly read-only) folders.
    """
    if final_root.exists():
        return
    tmp = final_root.with_name(final_root.name + ".tmp")
    old = final_root.with_name(final_root.name + ".old")
    if not (tmp / "manifest.json").exists() and not old.exists():
        return
    from .comments import comments_lock

    try:
        with comments_lock(final_root.parent, final_root.name):
            if final_root.exists():
                return  # a concurrent finalize/recovery won the race
            if (tmp / "manifest.json").exists():
                tmp.rename(final_root)
            elif old.exists():
                old.rename(final_root)
    except OSError:
        pass


@dataclass
class IndexWriter:
    """Append-only shard writer; ``finalize()`` atomically publishes.

    Usage:
        w = IndexWriter.create(folder, model="ViT-B/32", dim=512)
        w.append(embeddings, paths, metadata)   # any number of times
        w.finalize()
    """

    root: Path  # the staging directory (.clip_index.tmp)
    final_root: Path
    model: str
    dim: int
    dtype_name: str
    rows_per_shard: int
    count: int = 0
    shards: list[dict] = field(default_factory=list)
    _paths: list[str] = field(default_factory=list)
    _metadata: list[dict] = field(default_factory=list)
    _open_rows: list[np.ndarray] = field(default_factory=list)
    _open_count: int = 0

    @classmethod
    def create(
        cls,
        folder: str | os.PathLike,
        model: str,
        dim: int,
        dtype_name: str = "float32",
        rows_per_shard: int = DEFAULT_ROWS_PER_SHARD,
        index_folder_name: str = ".clip_index",
    ) -> "IndexWriter":
        final_root = index_dir(folder, index_folder_name)
        _recover_interrupted_swap(final_root)
        root = final_root.with_name(final_root.name + ".tmp")
        if root.exists():
            shutil.rmtree(root)
        (root / "shards").mkdir(parents=True)
        return cls(
            root=root, final_root=final_root, model=model, dim=dim,
            dtype_name=dtype_name, rows_per_shard=rows_per_shard,
        )

    def append(
        self, embeddings: np.ndarray, paths: list[str], metadata: list[dict]
    ) -> None:
        embeddings = np.asarray(embeddings)
        if embeddings.ndim != 2 or embeddings.shape[1] != self.dim:
            raise ValueError(f"bad embedding shape {embeddings.shape}, dim={self.dim}")
        if not (len(paths) == len(metadata) == embeddings.shape[0]):
            raise ValueError("row-misaligned append")
        self._open_rows.append(_to_storage(embeddings, self.dtype_name))
        self._open_count += embeddings.shape[0]
        self._paths.extend(paths)
        self._metadata.extend(metadata)
        self.count += embeddings.shape[0]
        flushed = False
        while self._open_count >= self.rows_per_shard:
            self._flush_shard(self.rows_per_shard)
            flushed = True
        if flushed:
            self._write_progress()

    def _flush_shard(self, rows: int) -> None:
        buf = np.concatenate(self._open_rows, axis=0)
        shard, rest = buf[:rows], buf[rows:]
        self._open_rows = [rest] if rest.size else []
        self._open_count = rest.shape[0] if rest.size else 0
        start = self._flushed_rows
        idx = len(self.shards)
        name = f"shards/emb_{idx:05d}.bin"
        raw = np.ascontiguousarray(shard).tobytes()
        (self.root / name).write_bytes(raw)
        # Per-shard paths/metadata sidecar, written ONCE at flush: resume
        # progress I/O stays O(rows) overall — re-serializing every done
        # row in progress.json on each flush was quadratic in corpus size
        # (hundreds of MB of JSON per write near the end of a 10M-row
        # build, on the host core that also bounds decode throughput).
        nrows = int(shard.shape[0])
        mdir = self.root / "progress_meta"
        mdir.mkdir(exist_ok=True)
        (mdir / f"meta_{idx:05d}.json").write_text(
            json.dumps({
                "paths": self._paths[start : start + nrows],
                "metadata": self._metadata[start : start + nrows],
            })
        )
        self.shards.append(
            {"file": name, "rows": nrows, "crc32": zlib.crc32(raw)}
        )

    def _manifest(self) -> dict:
        return {
            "version": FORMAT_VERSION,
            "model": self.model,
            "dim": self.dim,
            "dtype": self.dtype_name,
            "count": self.count,
            "shards": self.shards,
        }

    @property
    def _flushed_rows(self) -> int:
        return sum(s["rows"] for s in self.shards)

    def _write_progress(self) -> None:
        """Durable resume state, covering only rows already in shard files.

        Unflushed tail rows are re-embedded on resume — progress is durable
        exactly at shard granularity (SURVEY §5 checkpoint/resume plan).
        The covered rows' paths/metadata live in the per-shard
        ``progress_meta/`` sidecars written at flush time (_flush_shard);
        this file holds only the header + shard list. Write order makes a
        crash safe anywhere: a shard's bin + sidecar exist before any
        progress.json revision references it, and any inconsistency makes
        resume() return None (full rebuild).
        """
        tmp = self.root / "progress.json.tmp"
        tmp.write_text(
            json.dumps(
                {
                    "model": self.model,
                    "dim": self.dim,
                    "dtype": self.dtype_name,
                    "rows_per_shard": self.rows_per_shard,
                    "shards": self.shards,
                }
            )
        )
        tmp.replace(self.root / "progress.json")

    @classmethod
    def resume(
        cls,
        folder: str | os.PathLike,
        model: str,
        dim: int,
        index_folder_name: str = ".clip_index",
    ) -> "IndexWriter | None":
        """Reopen a crashed run's staging dir; None if absent/invalid."""
        final_root = index_dir(folder, index_folder_name)
        root = final_root.with_name(final_root.name + ".tmp")
        try:
            prog = json.loads((root / "progress.json").read_text())
            if prog["model"] != model or prog["dim"] != dim:
                return None
            itemsize = np.dtype(_dtype_of(prog["dtype"])).itemsize
            for shard in prog["shards"]:
                f = root / shard["file"]
                if not f.exists() or f.stat().st_size != shard["rows"] * dim * itemsize:
                    return None
            n = sum(s["rows"] for s in prog["shards"])
            done_paths, metadata = _read_progress_rows(root, prog)
            if not (len(done_paths) == len(metadata) == n):
                return None
            return cls(
                root=root, final_root=final_root, model=model, dim=dim,
                dtype_name=prog["dtype"], rows_per_shard=prog["rows_per_shard"],
                count=n, shards=list(prog["shards"]),
                _paths=done_paths, _metadata=metadata,
            )
        except Exception:
            return None

    def abandon(self) -> None:
        """Discard the staging dir (e.g. the folder had no images) so empty
        .clip_index.tmp dirs don't litter user folders."""
        if self.root.exists():
            shutil.rmtree(self.root, ignore_errors=True)

    def finalize(self) -> None:
        if self._open_count:
            self._flush_shard(self._open_count)
        (self.root / "paths.json").write_text(json.dumps(self._paths))
        (self.root / "metadata.json").write_text(json.dumps(self._metadata))
        (self.root / "manifest.json").write_text(json.dumps(self._manifest()))
        (self.root / "progress.json").unlink(missing_ok=True)
        shutil.rmtree(self.root / "progress_meta", ignore_errors=True)
        # Atomic publish: move live index away (preserving comments.json),
        # move staging in, then clean up. The swap holds the comments lock
        # so a concurrent comment append can't land in the doomed old dir
        # and silently vanish (the lock file lives OUTSIDE the swapped dir).
        from .comments import comments_lock

        old = self.final_root.with_name(self.final_root.name + ".old")
        if old.exists():
            shutil.rmtree(old)
        with comments_lock(self.final_root.parent, self.final_root.name):
            if self.final_root.exists():
                comments = self.final_root / "comments.json"
                if comments.exists():
                    shutil.copy2(comments, self.root / "comments.json")
                self.final_root.rename(old)
            try:
                self.root.rename(self.final_root)
            except OSError:
                # Belt-and-braces: if someone promoted our fully-written
                # staging dir already (pre-lock recovery code, external
                # tooling), the publish still succeeded — don't 500.
                if (self.final_root / "manifest.json").exists():
                    pass
                elif (
                    not self.root.exists()
                    and (old / "manifest.json").exists()
                ):
                    # First-publish race: a concurrent reader's
                    # _recover_interrupted_swap promoted our staging dir
                    # between the manifest write above and taking the
                    # lock; the final_root we displaced to .old a few
                    # lines up WAS the promoted new index (recovery only
                    # fires when no live index existed). Put it back.
                    old.rename(self.final_root)
                else:
                    raise
        if old.exists():
            shutil.rmtree(old)


@dataclass
class IndexReader:
    """Read view over a published index; embeddings are np.memmap-backed."""

    root: Path
    model: str
    dim: int
    dtype_name: str
    count: int
    paths: list[str]
    metadata: list[dict] | None
    _shards: list[dict] = field(default_factory=list)
    _mmaps: list[np.ndarray] | None = None

    @classmethod
    def open(
        cls,
        folder: str | os.PathLike,
        index_folder_name: str = ".clip_index",
        verify_checksums: bool = False,
    ) -> "IndexReader | None":
        """Open an index; returns None on ANY failure (reference
        load_index semantics, oldapp.py:108-135)."""
        root = index_dir(folder, index_folder_name)
        _recover_interrupted_swap(root)
        try:
            manifest_bytes = (root / "manifest.json").read_bytes()
            manifest = json.loads(manifest_bytes)
            if manifest["version"] > FORMAT_VERSION:
                return None
            paths = json.loads((root / "paths.json").read_text())
            if len(paths) != manifest["count"]:
                return None
            try:
                metadata = json.loads((root / "metadata.json").read_text())
                if len(metadata) != manifest["count"]:
                    metadata = None
            except (OSError, ValueError):
                metadata = None  # metadata optional for back compat
            reader = cls(
                root=root, model=manifest["model"], dim=manifest["dim"],
                dtype_name=manifest["dtype"], count=manifest["count"],
                paths=paths, metadata=metadata, _shards=manifest["shards"],
            )
            # Validate shard presence/sizes up front so a truncated file is
            # "not indexed" instead of a mid-search crash.
            itemsize = np.dtype(_dtype_of(manifest["dtype"])).itemsize
            for shard in manifest["shards"]:
                f = root / shard["file"]
                expect = shard["rows"] * manifest["dim"] * itemsize
                if not f.exists() or f.stat().st_size != expect:
                    return None
                if verify_checksums and zlib.crc32(f.read_bytes()) != shard["crc32"]:
                    return None
            if sum(s["rows"] for s in manifest["shards"]) != manifest["count"]:
                return None
            # Materialize the mmaps INSIDE the validated window: once
            # mapped, a concurrent publish renaming the files away cannot
            # tear this reader (POSIX keeps mapped files alive); lazy
            # mapping left a gap where open() succeeded but the first
            # shard access raised FileNotFoundError mid-request.
            reader.shard_arrays()
            # Post-map revalidation: a publish could swap the whole dir
            # between the size checks above and the mmap, mapping the NEW
            # index's shard bytes under the OLD manifest's paths/count
            # (silently wrong pairings when the new index is larger). The
            # manifest carries per-shard CRCs, so byte-identity here
            # proves the mapped files belong to this manifest; any change
            # reads as "not indexed" and the caller reopens.
            if (root / "manifest.json").read_bytes() != manifest_bytes:
                return None
            return reader
        except Exception:
            return None

    def shard_arrays(self) -> list[np.ndarray]:
        """Per-shard memory-mapped (rows, dim) arrays."""
        if self._mmaps is None:
            dt = _dtype_of(self.dtype_name)
            self._mmaps = [
                np.memmap(
                    self.root / s["file"], dtype=dt, mode="r",
                    shape=(s["rows"], self.dim),
                )
                for s in self._shards
            ]
        return self._mmaps

    def embeddings(self) -> np.ndarray:
        """Full (count, dim) matrix; zero-copy when there is one shard."""
        arrays = self.shard_arrays()
        if len(arrays) == 1:
            return arrays[0]
        if not arrays:
            return np.zeros((0, self.dim), dtype=_dtype_of(self.dtype_name))
        return np.concatenate(arrays, axis=0)

    def mtime(self) -> float:
        """Manifest mtime — cache-invalidation token for engine caches."""
        try:
            return (self.root / "manifest.json").stat().st_mtime
        except OSError:
            return 0.0


def _read_progress_rows(root, prog: dict) -> tuple[list, list]:
    """(paths, metadata) covered by a progress file: per-shard sidecars
    in the current format, inline lists in the legacy one. Raises on a
    missing/misaligned sidecar — callers treat that as "no resume"."""
    if "done_paths" in prog:  # legacy inline format (pre per-shard meta)
        return list(prog["done_paths"]), list(prog["metadata"])
    paths: list = []
    metadata: list = []
    for i, shard in enumerate(prog["shards"]):
        m = json.loads(
            (root / "progress_meta" / f"meta_{i:05d}.json").read_text()
        )
        if not (len(m["paths"]) == len(m["metadata"]) == shard["rows"]):
            raise ValueError("misaligned progress sidecar")
        paths.extend(m["paths"])
        metadata.extend(m["metadata"])
    return paths, metadata


def load_progress(
    folder: str | os.PathLike, index_folder_name: str = ".clip_index"
) -> set[str]:
    """Paths already embedded by a crashed/partial indexing run."""
    root = index_dir(folder, index_folder_name)
    tmp = root.with_name(root.name + ".tmp")
    try:
        prog = json.loads((tmp / "progress.json").read_text())
        return set(_read_progress_rows(tmp, prog)[0])
    except Exception:
        return set()


def exists(folder: str | os.PathLike, index_folder_name: str = ".clip_index") -> bool:
    return IndexReader.open(folder, index_folder_name) is not None
