"""Batched, resumable folder indexing.

Replaces the reference's serial one-image-at-a-time loop (`create_index`,
oldapp.py:54-90; batch size 1, full Python round-trip per image) with a
batched pipeline: host decode/prepare -> device fused preprocess+encode in
``batch_size`` chunks -> shard store appends. Per-image decode failures are
logged and skipped, exactly like the reference (oldapp.py:79-80), and
progress is durable at shard granularity so a crashed run resumes.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Callable, Iterable

import numpy as np

from ..preprocess.io import load_batch_rgb, load_image_rgb
from ..utils import get_logger
from .store import IndexWriter, as_float32, load_progress

log = get_logger("index.builder")

# Reference extension set (config.py:39); scan is non-recursive and
# case-sensitive like the reference's per-extension glob (oldapp.py:64-65),
# but deterministic: extensions and matches are sorted.
DEFAULT_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def scan_folder(
    folder: str | os.PathLike, extensions: Iterable[str] = DEFAULT_EXTENSIONS
) -> list[Path]:
    folder = Path(folder)
    found: list[Path] = []
    for ext in sorted(extensions):
        found.extend(
            # skip dot-prefixed hidden files: the reference's glob.glob
            # never matches them for a '*' pattern, while pathlib's glob
            # does — without this, macOS AppleDouble junk (._IMG.jpg)
            # warns on every run and hidden images become search results
            # the reference would never return
            sorted(p for p in folder.glob(f"*{ext}")
                   if not p.name.startswith("."))
        )
    return found


def build_index(
    folder: str | os.PathLike,
    encode_batch: Callable[[list], np.ndarray] | None = None,
    model_name: str = "",
    dim: int = 0,
    batch_size: int = 32,
    dtype_name: str = "float32",
    extensions: Iterable[str] = DEFAULT_EXTENSIONS,
    index_folder_name: str = ".clip_index",
    resume: bool = False,
    rows_per_shard: int | None = None,
    fast_decode: bool = True,
    decode_short_side: int = 448,
    pipeline_encoder=None,
    incremental: bool = False,
) -> int:
    """Index every image in ``folder``; returns number of rows written.

    ``encode_batch``: list of PIL images / uint8 RGB arrays -> (B, dim)
    float32 embeddings (the engine provides preprocess+encode fused on
    device). Returns 0 and writes nothing when the folder has no readable
    images (reference returns None -> HTTP 400, oldapp.py:82-83/1964).
    ``fast_decode`` is kept for call compatibility: decode is always PIL
    at full resolution here.
    """
    paths = scan_folder(folder, extensions)
    done: set[str] = set()
    writer = None
    if resume:
        writer = IndexWriter.resume(
            folder, model_name, dim, index_folder_name=index_folder_name
        )
        if writer is not None:
            done = load_progress(folder, index_folder_name)
            log.info("resuming indexing of %s: %d rows already embedded",
                     folder, len(done))
    if writer is None:
        kwargs = {}
        if rows_per_shard is not None:
            kwargs["rows_per_shard"] = rows_per_shard
        writer = IndexWriter.create(
            folder, model=model_name, dim=dim, dtype_name=dtype_name,
            index_folder_name=index_folder_name, **kwargs,
        )
        if incremental:
            done |= _reuse_unchanged_rows(
                folder, paths, writer, model_name, dim, index_folder_name
            )

    if pipeline_encoder is not None:
        _pipelined_build(
            paths, done, writer, pipeline_encoder, batch_size,
            fast_decode, decode_short_side,
        )
    else:
        pending_imgs: list = []
        pending_paths: list[str] = []
        pending_meta: list[dict] = []

        def flush():
            nonlocal pending_imgs, pending_paths, pending_meta
            if not pending_imgs:
                return
            emb = np.asarray(encode_batch(pending_imgs), dtype=np.float32)
            writer.append(emb, pending_paths, pending_meta)
            pending_imgs, pending_paths, pending_meta = [], [], []

        for img_path in paths:
            spath = str(img_path)
            if spath in done:
                continue
            try:
                img = load_image_rgb(
                    img_path,
                    min_short_side=decode_short_side if fast_decode else 0,
                    fast=fast_decode,
                )
                stat = img_path.stat()
            except Exception as e:  # skip-and-continue (oldapp.py:79-80)
                log.warning("Error processing %s: %s", img_path, e)
                continue
            pending_imgs.append(img)
            pending_paths.append(spath)
            pending_meta.append(
                {"path": spath, "mtime": stat.st_mtime, "size": stat.st_size}
            )
            if len(pending_imgs) >= batch_size:
                flush()
        flush()

    if writer.count == 0:
        writer.abandon()  # no empty staging-dir litter (review finding)
        return 0
    writer.finalize()
    log.info("indexed %d images in %s", writer.count, folder)
    return writer.count


def _reuse_unchanged_rows(
    folder, paths, writer, model_name: str, dim: int, index_folder_name: str
) -> set[str]:
    """Incremental re-index: copy embeddings of files whose (mtime, size)
    is unchanged since the live index was built. The reference always
    re-embeds everything (oldapp.py:54-90); with mtime+size identity this
    turns routine re-indexing of a big folder into a metadata diff plus a
    handful of new embeddings. Returns the set of reused paths.
    """
    from .store import IndexReader

    old = IndexReader.open(folder, index_folder_name)
    if old is None or old.model != model_name or old.dim != dim or not old.metadata:
        return set()
    by_path = {m["path"]: (row, m) for row, m in enumerate(old.metadata)}
    reuse_rows: list[int] = []
    reuse_paths: list[str] = []
    reuse_meta: list[dict] = []
    for p in paths:
        sp = str(p)
        hit = by_path.get(sp)
        if hit is None:
            continue
        row, meta = hit
        try:
            stat = p.stat()
        except OSError:
            continue
        if meta.get("mtime") == stat.st_mtime and meta.get("size") == stat.st_size:
            reuse_rows.append(row)
            reuse_paths.append(sp)
            reuse_meta.append(meta)
    if not reuse_rows:
        return set()
    # Copy shard-by-shard straight from the mmaps — old.embeddings() would
    # materialize the whole matrix in RAM for multi-shard indexes (20 GB at
    # 10M x 512 f32). reuse_rows is ascending (scan order follows metadata
    # row order within each shard is irrelevant; we just range-partition).
    order = np.argsort(reuse_rows, kind="stable")
    rows_sorted = np.asarray(reuse_rows)[order]
    paths_sorted = [reuse_paths[i] for i in order]
    meta_sorted = [reuse_meta[i] for i in order]
    offset = 0
    cursor = 0
    for shard in old.shard_arrays():
        hi = offset + shard.shape[0]
        end = cursor + int(np.searchsorted(rows_sorted[cursor:], hi))
        if end > cursor:
            local = rows_sorted[cursor:end] - offset
            writer.append(
                as_float32(shard[local]),
                paths_sorted[cursor:end],
                meta_sorted[cursor:end],
            )
        cursor = end
        offset = hi
    log.info("incremental: reused %d unchanged embeddings", len(reuse_rows))
    return set(reuse_paths)


def _pipelined_build(
    paths, done, writer, encoder, batch_size, fast_decode, decode_short_side,
) -> None:
    """Overlapped host/device indexing pipeline.

    A producer thread decodes + host-prepares batches (PIL decode releases
    the GIL) while the device runs the fused preprocess+encode on the
    previous batch — double buffering via a bounded queue. Every image
    travels as RGB (the planar JPEG route needs the native decoder, which
    this package does not have).
    """
    import queue
    import threading
    from contextlib import nullcontext

    from ..preprocess import prepare_batch
    from ..preprocess.pipeline import MAX_UNIQUE_SIZES

    target = encoder.spec.image_size
    out: "queue.Queue" = queue.Queue(maxsize=3)
    cancelled = threading.Event()

    def safe_put(item) -> bool:
        """put() that gives up when the consumer has cancelled the build
        (a plain blocking put on the bounded queue would wedge the
        producer thread forever if the consumer died)."""
        while not cancelled.is_set():
            try:
                out.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    timers = getattr(encoder, "timers", None)

    def timed(stage: str):
        # Stage timers run in the producer thread concurrently with the
        # device consumer, so stage sums can exceed wall time — they
        # measure per-stage cost, not the (overlapped) critical path.
        return timers.stage(stage) if timers is not None else nullcontext()

    def producer():
        batch: list = []
        bpaths: list = []
        bmeta: list = []
        sizes: set = set()

        def emit() -> bool:
            nonlocal batch, bpaths, bmeta, sizes
            if not batch:
                return True
            with timed("index_prepare"):
                prepared = prepare_batch(batch, target=target)
            ok = safe_put((prepared, bpaths, bmeta))
            batch, bpaths, bmeta, sizes = [], [], [], set()
            return ok

        try:
            todo = [p for p in paths if str(p) not in done]
            for start in range(0, len(todo), batch_size):
                if cancelled.is_set():
                    return
                chunk = todo[start : start + batch_size]
                with timed("index_decode"):
                    entries = load_batch_rgb(
                        chunk,
                        min_short_side=decode_short_side if fast_decode else 0,
                        fast=fast_decode,
                    )
                for img_path, entry in zip(chunk, entries):
                    if entry is None:  # oldapp.py:79-80 semantics
                        log.warning("Error processing %s: undecodable", img_path)
                        continue
                    try:
                        stat = img_path.stat()
                    except OSError as e:
                        log.warning("Error processing %s: %s", img_path, e)
                        continue
                    hw = entry.shape[:2]
                    # flush BEFORE admitting a new distinct size past the
                    # cap (bounds the per-unique-size resample matrices;
                    # see preprocess.pipeline.MAX_UNIQUE_SIZES)
                    if hw not in sizes and len(sizes) >= MAX_UNIQUE_SIZES:
                        if not emit():
                            return
                    spath = str(img_path)
                    batch.append(entry)
                    sizes.add(hw)
                    bpaths.append(spath)
                    bmeta.append(
                        {"path": spath, "mtime": stat.st_mtime,
                         "size": stat.st_size}
                    )
                    if len(batch) >= batch_size:
                        if not emit():
                            return
            if emit():
                safe_put(None)
        except BaseException as e:  # surface producer crashes to the consumer
            safe_put(e)

    # Deferred fetch: dispatch batch N+1's encode BEFORE copying batch N's
    # embeddings to the host, so the copy waits on work that has already
    # run while batch N+1 was decoded. One batch deep: append order (= row
    # order) is preserved.
    deferred = getattr(encoder, "supports_deferred_fetch", False)

    thread = threading.Thread(target=producer, name="index-producer", daemon=True)
    thread.start()
    pending = None  # (PendingEmbeddings, paths, meta)
    try:
        while True:
            item = out.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            prepared, bpaths, bmeta = item
            if deferred:
                pend = encoder.encode_prepared(*prepared, fetch=False)
                if pending is not None:
                    writer.append(pending[0].resolve(), pending[1], pending[2])
                pending = (pend, bpaths, bmeta)
            else:
                emb = encoder.encode_prepared(*prepared)
                writer.append(np.asarray(emb, np.float32), bpaths, bmeta)
        if pending is not None:
            writer.append(pending[0].resolve(), pending[1], pending[2])
            pending = None
        thread.join()
    except BaseException:
        # Consumer failure (ENOSPC, CUDA error, ...): signal the producer
        # and drain the bounded queue so its blocked put() can complete —
        # otherwise the thread (plus up to 3 decoded canvas batches)
        # leaks for the process lifetime on every failed /index.
        cancelled.set()
        while thread.is_alive():
            try:
                out.get(timeout=0.1)
            except queue.Empty:
                pass
        raise
