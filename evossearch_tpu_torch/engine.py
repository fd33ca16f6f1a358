"""SearchEngine — the engine layer tying tokenizer, CLIP towers, the fused
preprocess and the shard store into the operations the HTTP layer needs.
PyTorch counterpart of ``evossearch_tpu/engine.py`` (exact search on one
device or row-sharded over every visible card, or the IVF index under
``INDEX_KIND=ivf``; for over-budget corpora the host IVF probe of a
persisted sidecar, the SQ8 capacity tier on the device or the mesh, else
the host scan).

  * the engine runs on ``"cuda"`` unless the caller passes
    ``device="cpu"``; with no GPU and no explicit device it raises. With
    more than one visible card, ``SEARCH_KERNEL=auto`` shards each corpus
    over them (``parallel/``, the ``sharded`` kernel) and ``DP_ENCODE``
    splits each indexing batch across them;
  * encoders run batched, padded to power-of-two buckets;
  * loaded indexes are cached on the device keyed by manifest mtime, under
    a device-memory budget with LRU eviction;
  * weights come from the configured checkpoint (a native npz, an OpenAI
    ``.pt`` or a HuggingFace directory, converted by
    ``models.load_checkpoint``), else a seeded random init
    (``torch.Generator().manual_seed(0)``; the numbers differ from the JAX
    package's ``jax.random.key(0)`` init);
  * indexing decodes JPEGs with the package's native libjpeg extension at
    a reduced DCT scale (``FAST_DECODE``) into planar 4:2:0 planes that
    the device converts to RGB (``PLANAR_JPEG``), Pillow otherwise.

The whole engine is ported; the mesh half of training (``train/``) is
not.
"""

from __future__ import annotations

import copy
import functools
import hashlib
import os
import threading
import time
from collections import OrderedDict

import numpy as np
import torch

from .core import CLIP_MODEL_SPECS, Config, config as default_config
from .core.constants import CLIPModelSpec
from .core.device import resolve_device
from .index import build_index
from .index.store import IndexReader, as_float32
from .ops import fused
from .tokenizer import load_tokenizer
from .utils import Counters, StageTimer, get_logger

log = get_logger("engine")

# Logged when a GPU engine loads or builds an IVF index: what
# chip_smoke.py's ``ivf`` phase measured of IVF against exact search.
IVF_ON_GPU_WARNING = (
    "INDEX_KIND=ivf on a GPU: on an NVIDIA H100 80GB HBM3 (700 W), over "
    "1,048,576 clustered bf16 rows of d=512 at the calibrated nprobe (3 of "
    "1,024 lists; chip_smoke.py, phase ivf, three runs), exact search "
    "answered a batch of 48 queries in 0.93-1.23 ms against IVF's "
    "2.96-7.59 ms, and one query in 0.72-1.00 ms against IVF's "
    "0.53-1.28 ms; exact search (EVOSSEARCH_INDEX_KIND=exact) returns the "
    "exact top-k"
)

_UNSET = object()  # lock-free "not initialized" sentinel (batchers, SQ8)

# Cache-entry fields holding a folder's device state, each charged to the
# entry's device_bytes and dropped together on eviction.
_DEVICE_TIERS = ("emb", "sharded", "ivf", "sharded_ivf", "sq8")


def _bucket(n: int, cap: int) -> int:
    """Smallest power-of-two >= n, capped."""
    b = 1
    while b < n and b < cap:
        b <<= 1
    return min(b, cap)


class PendingEmbeddings:
    """Deferred result of ``encode_prepared(..., fetch=False)``: the encode
    is queued on the device; :meth:`resolve` copies the (n, embed_dim)
    float32 embeddings to the host, or :meth:`on_device` hands them over
    where they lie. Single-use."""

    def __init__(self, buckets: list, n: int, engine: "SearchEngine"):
        self._buckets = buckets
        self._n = n
        self._engine = engine

    def resolve(self) -> np.ndarray:
        eng = self._engine
        if self._n == 0:
            return np.zeros((0, eng.spec.embed_dim), np.float32)
        with eng.timers.stage("prep_encode_fetch"):
            out = [b.cpu().numpy() for b in self._buckets]
        self._buckets = []  # free the device buffers promptly
        emb = np.concatenate(out, axis=0)[: self._n]
        eng.counters.add("images_encoded", self._n)
        return emb

    def on_device(self) -> torch.Tensor:
        """The (n, embed_dim) float32 embeddings on the device, counted as
        encoded as :meth:`resolve` counts them."""
        eng = self._engine
        if self._n == 0:
            return torch.zeros((0, eng.spec.embed_dim), device=eng.device)
        rows = self._buckets[0] if len(self._buckets) == 1 else torch.cat(self._buckets)
        self._buckets = []
        eng.counters.add("images_encoded", self._n)
        return rows[: self._n]


def _canon(folder: str) -> str:
    """Canonical cache/lock key for a folder (relative vs absolute,
    ``a/../b`` and symlinks name one physical directory)."""
    return os.path.realpath(folder)


class SearchEngine:
    def __init__(
        self,
        cfg: Config | None = None,
        spec: CLIPModelSpec | None = None,
        params=None,
        device: str | torch.device | None = None,
    ):
        """``params``: a port :class:`~.models.CLIP` module, or the JAX
        package's param pytree with numpy leaves (bridged by
        ``params_from_numpy``); None loads ``CHECKPOINT_PATH`` or inits
        randomly."""
        self.cfg = cfg or default_config
        self.device = resolve_device(device)
        if spec is None and self.cfg.CLIP_MODEL not in CLIP_MODEL_SPECS:
            raise ValueError(
                f"unknown CLIP model {self.cfg.CLIP_MODEL!r} "
                f"(EVOSSEARCH_CLIP_MODEL); available: "
                f"{', '.join(CLIP_MODEL_SPECS)}"
            )
        self.spec = spec or CLIP_MODEL_SPECS[self.cfg.CLIP_MODEL]
        self.tokenizer = load_tokenizer(self.cfg.BPE_VOCAB_PATH or None)
        if params is not None and not isinstance(params, torch.nn.Module):
            from .models import params_from_numpy

            params = params_from_numpy(params, self.spec, self.device)
        self._params = None if params is None else params.to(self.device)
        self._params_lock = threading.Lock()
        self._replicas: dict = {}  # device -> a copy of the towers (DP encode)
        if params is None and self.cfg.CHECKPOINT_PATH:
            # eager: the checkpoint may carry another architecture, and
            # loading overwrites self.spec, which index manifests capture
            self._params = self._load_params()
        self._index_cache: "OrderedDict[str, dict]" = OrderedDict()
        self._cache_lock = threading.Lock()
        self._max_cached_folders = 4
        self._folder_locks: dict[str, threading.Lock] = {}
        self._text_cache: "OrderedDict[str, object]" = OrderedDict()
        self._text_cache_lock = threading.Lock()
        self._mat_cache: "OrderedDict[tuple, tuple]" = OrderedDict()
        self._mat_cache_lock = threading.Lock()
        self.timers = StageTimer()
        self.counters = Counters()

    def close(self) -> None:
        """Stop the batcher worker threads."""
        for attr in ("_batcher_inst", "_host_batcher_inst",
                     "_text_batcher_inst", "_fused_batcher_inst"):
            inst = self.__dict__.get(attr)
            if inst is not None:
                inst.close()

    # -- model/params --

    @property
    def params(self):
        """The CLIP module on the engine's device."""
        with self._params_lock:
            if self._params is None:
                self._params = self._load_params()
            return self._params

    def _load_params(self):
        from .models import CLIP, load_checkpoint, load_model, params_from_numpy

        path = self.cfg.CHECKPOINT_PATH
        if path:
            if path.endswith(".npz"):  # the native checkpoint format
                model, spec = load_model(path, self.device)
            else:  # OpenAI .pt / HF directory
                tree, spec = load_checkpoint(path)
                model = params_from_numpy(tree, spec, self.device)
            self.spec = spec
            log.info("loaded checkpoint %s (%s)", path, spec.name)
            return model
        log.warning(
            "no checkpoint configured (EVOSSEARCH_CHECKPOINT); using "
            "seeded random-init %s weights", self.spec.name,
        )
        gen = torch.Generator().manual_seed(0)
        return CLIP(self.spec).init_random_(gen).to(self.device).eval()

    @functools.cached_property
    def _compute_dtype(self) -> torch.dtype:
        return (
            torch.bfloat16 if self.cfg.COMPUTE_DTYPE == "bfloat16"
            else torch.float32
        )

    # -- encoders --

    def _encode_tokens(self, tokens) -> torch.Tensor:
        """(B, ctx) token ids -> (B, embed_dim) float32 device rows."""
        from .models import encode_text

        t = torch.as_tensor(np.asarray(tokens), device=self.device)
        with fused.counting(self.counters):
            return encode_text(self.params, t, self._compute_dtype)

    def _prep_encode(self, params, canvases, a_h_u, a_w_u,
                     size_idx) -> torch.Tensor:
        """Fused resample + crop + normalize + image tower (``params``, on
        the inputs' device)."""
        from .models import encode_image
        from .preprocess import device_preprocess_indexed

        x = device_preprocess_indexed(
            canvases, a_h_u, a_w_u, size_idx, out_dtype=self._compute_dtype
        )
        with fused.counting(self.counters):
            return encode_image(params, x, self._compute_dtype)

    def _prep_encode_planar(self, params, y, c, a_h_y, a_w_y, a_h_c, a_w_c,
                            size_idx) -> torch.Tensor:
        """Planar twin of _prep_encode: chroma-upsampling resample +
        YCbCr->RGB + normalize + image tower, fed by the native planar JPEG
        decode (half the host->device canvas bytes of RGB)."""
        from .models import encode_image
        from .preprocess import device_preprocess_planar_indexed

        x = device_preprocess_planar_indexed(
            y, c, a_h_y, a_w_y, a_h_c, a_w_c, size_idx,
            out_dtype=self._compute_dtype,
        )
        with fused.counting(self.counters):
            return encode_image(params, x, self._compute_dtype)

    @functools.cached_property
    def _encode_devices(self) -> list | None:
        """The devices of data-parallel indexing encode: every visible card
        when DP_ENCODE is on and there is more than one, else None (the
        engine's device alone)."""
        from .parallel import mesh

        devices = mesh.available_devices(self.device)
        return devices if self.cfg.DP_ENCODE and len(devices) > 1 else None

    def _replica(self, device: torch.device):
        """The towers on ``device``: the engine's own module on its device,
        one copy per other device, made at first use."""
        params = self.params
        if device == self.device:
            return params
        with self._params_lock:
            rep = self._replicas.get(device)
            if rep is None:
                rep = self._replicas[device] = copy.deepcopy(params).to(device)
            return rep

    @property
    def _index_batch(self) -> int:
        """Images per encode in the indexing pipeline (and the bucket cap)."""
        return self.cfg.INDEX_BATCH or max(self.cfg.BATCH_SIZE, 128)

    def _device_mats(self, mats: tuple, device: torch.device) -> tuple:
        """Device-resident LRU of per-batch resample matrices, keyed by
        device and content: a homogeneous folder ships identical stacks
        every batch."""
        key = (device,) + tuple(
            (m.shape, hashlib.blake2b(m.tobytes(), digest_size=16).digest())
            for m in mats
        )
        with self._mat_cache_lock:
            cached = self._mat_cache.get(key)
            if cached is not None:
                self._mat_cache.move_to_end(key)
                return cached
        out = tuple(torch.from_numpy(m).to(device) for m in mats)
        with self._mat_cache_lock:
            self._mat_cache[key] = out
            self._mat_cache.move_to_end(key)
            while len(self._mat_cache) > 16:
                self._mat_cache.popitem(last=False)
        return out

    def _encode_prepared_impl(self, canvases: tuple, mats: tuple,
                              size_idx: np.ndarray, fetch: bool, encode):
        """The bucket padding and two-in-flight pipeline shared by
        encode_prepared (one RGB canvas) and encode_prepared_planar (luma
        and chroma canvases); ``encode(params, canvas_tensors,
        mat_tensors, idx)`` queues one bucket's fused preprocess + encode
        on the device the tensors lie on.

        Under data-parallel encode each bucket is padded to a multiple of
        the device count and split into equal contiguous chunks, each
        encoded on its device and gathered to the engine's device in
        order. Two buckets in flight: bucket i+1's upload and encode are
        queued before bucket i is copied back. ``fetch=False`` returns a
        :class:`PendingEmbeddings` whose ``resolve()`` does the
        device->host copy later. Timed as ``encode_inputs`` (the padding
        to the bucket and the resample matrices' device cache), then
        ``prep_encode`` (off the timeline), split into ``encode_upload``
        (the host-to-device copies) and ``encode_dispatch`` (the towers'
        launches)."""
        n = canvases[0].shape[0]
        if n == 0:
            empty = np.zeros((0, self.spec.embed_dim), np.float32)
            return empty if fetch else PendingEmbeddings([], 0, self)
        devices = self._encode_devices or [self.device]
        b = _bucket(n, max(self._index_batch, 1))
        b = -(-b // len(devices)) * len(devices)  # equal rows per device
        with self.timers.stage("encode_inputs"):
            if n < b or n % b:
                pad = -(-n // b) * b - n
                canvases = tuple(
                    np.concatenate([c, np.zeros((pad,) + c.shape[1:], c.dtype)])
                    for c in canvases
                )
                size_idx = np.concatenate([size_idx, np.zeros(pad, size_idx.dtype)])
            mats_d = {dev: self._device_mats(mats, dev) for dev in dict.fromkeys(devices)}
        per = b // len(devices)
        out = []
        in_flight: list = []
        with self.timers.stage("prep_encode", enclosing=True):
            for start in range(0, canvases[0].shape[0], b):
                self.counters.add("upload_canvas_bytes", sum(
                    int(c[start : start + b].nbytes) for c in canvases))
                parts = []
                for j, dev in enumerate(devices):
                    sl = slice(start + j * per, start + (j + 1) * per)
                    # pageable copies: each first waits for the work the
                    # stream already holds
                    with self.timers.stage("encode_upload"):
                        cs = tuple(torch.from_numpy(c[sl]).to(dev) for c in canvases)
                        idx = torch.from_numpy(size_idx[sl]).to(dev)
                    with self.timers.stage("encode_dispatch"):
                        parts.append(encode(self._replica(dev), cs, mats_d[dev], idx)
                                     .to(self.device))
                in_flight.append(parts[0] if len(parts) == 1 else torch.cat(parts))
                if fetch and len(in_flight) >= 2:
                    out.append(in_flight.pop(0).cpu().numpy())
            if not fetch:
                return PendingEmbeddings(in_flight, n, self)
            out.extend(o.cpu().numpy() for o in in_flight)
        emb = np.concatenate(out, axis=0)[:n]
        self.counters.add("images_encoded", n)
        return emb

    def encode_prepared(
        self, canvases: np.ndarray, a_h_u: np.ndarray, a_w_u: np.ndarray,
        size_idx: np.ndarray, fetch: bool = True,
    ):
        """Host-prepared batch (canvases + unique-size resample matrices +
        per-image size index) -> (B, embed_dim) embeddings, padded to a
        bucket size (``fetch=False``: see _encode_prepared_impl)."""
        return self._encode_prepared_impl(
            (canvases,), (a_h_u, a_w_u), size_idx, fetch,
            lambda params, cs, mats, idx: self._prep_encode(
                params, cs[0], *mats, idx),
        )

    def encode_prepared_planar(
        self, y_canvas: np.ndarray, c_canvas: np.ndarray,
        a_h_y: np.ndarray, a_w_y: np.ndarray,
        a_h_c: np.ndarray, a_w_c: np.ndarray, size_idx: np.ndarray,
        fetch: bool = True,
    ):
        """prepare_batch_planar output -> (B, embed_dim) embeddings through
        the fused planar preprocess; the same bucket padding and
        ``fetch=False`` deferral as encode_prepared."""
        return self._encode_prepared_impl(
            (y_canvas, c_canvas), (a_h_y, a_w_y, a_h_c, a_w_c), size_idx,
            fetch,
            lambda params, cs, mats, idx: self._prep_encode_planar(
                params, *cs, *mats, idx),
        )

    @staticmethod
    def _as_rgb(img) -> np.ndarray:
        if isinstance(img, np.ndarray):
            return img
        if img.mode != "RGB":
            img = img.convert("RGB")
        return np.asarray(img, dtype=np.uint8)

    def encode_images(self, images: list) -> np.ndarray:
        """PIL images / uint8 RGB arrays -> (B, embed_dim) L2-normalized
        float32 embeddings."""
        from .preprocess import prepare_batch
        from .preprocess.pipeline import MAX_UNIQUE_SIZES

        if len(images) == 0:
            return np.zeros((0, self.spec.embed_dim), np.float32)
        arrays = [self._as_rgb(img) for img in images]
        # groups of <= MAX_UNIQUE_SIZES distinct sizes bound the
        # per-unique-size resample matrices
        groups: list[list] = [[]]
        sizes: set = set()
        for a in arrays:
            hw = a.shape[:2]
            if hw not in sizes and len(sizes) >= MAX_UNIQUE_SIZES:
                groups.append([])
                sizes = set()
            groups[-1].append(a)
            sizes.add(hw)
        outs = []
        for group in groups:
            with self.timers.stage("preprocess"):
                prepared = prepare_batch(group, target=self.spec.image_size)
            outs.append(self.encode_prepared(*prepared))
        return outs[0] if len(outs) == 1 else np.concatenate(outs, axis=0)

    def encode_image_device(self, img) -> torch.Tensor:
        """One image -> (1, embed_dim) float32 row left on the device, so
        the search that follows needs no host round trip for the query."""
        from .preprocess import prepare_batch

        with self.timers.stage("preprocess"):
            prepared = prepare_batch(
                [self._as_rgb(img)], target=self.spec.image_size
            )
        return self.encode_prepared(*prepared, fetch=False).on_device()

    def encode_text(self, text: str) -> np.ndarray:
        """Query text -> (embed_dim,) L2-normalized float32 embedding.
        With the byte-level fallback tokenizer long queries are truncated;
        with a real vocab an overflow raises like ``clip.tokenize``."""
        emb = self._encode_text_device(text)  # device row or cached numpy
        if isinstance(emb, torch.Tensor):
            emb = emb.cpu().numpy()
        return np.asarray(emb, np.float32)[0]

    def _encode_text_device(self, text: str):
        """encode_text leaving the embedding on the device as a (1, d)
        row, behind a small LRU of repeated queries."""
        with self._text_cache_lock:
            cached = self._text_cache.get(text)
            if cached is not None:
                self._text_cache.move_to_end(text)
                self.counters.add("text_cache_hits")
                return cached
        with self.timers.stage("encode_text"):
            tokens = self.tokenizer.tokenize(
                [text], self.spec.context_length,
                truncate=self.tokenizer.fallback,
            )
            batcher = self._text_batcher
            if batcher is not None:
                emb = batcher.submit(np.asarray(tokens[0], np.int32))
            else:
                emb = self._encode_tokens(tokens)
        self.counters.add("texts_encoded")
        self._text_cache_put(text, emb)
        return emb

    def _text_cache_put(self, text: str, emb) -> None:
        with self._text_cache_lock:
            self._text_cache[text] = emb
            self._text_cache.move_to_end(text)
            while len(self._text_cache) > 1024:
                self._text_cache.popitem(last=False)

    # -- index operations --

    def index_folder(
        self, folder: str, resume: bool = False, incremental: bool | None = None
    ) -> int:
        """Batched (re)index of a folder; returns row count (0 = no images)."""
        if incremental is None:
            incremental = self.cfg.INCREMENTAL_INDEX
        with self._folder_lock(folder), self.timers.stage("index_folder", enclosing=True):
            count = build_index(
                folder,
                pipeline_encoder=self,
                incremental=incremental,
                model_name=self.spec.name,
                dim=self.spec.embed_dim,
                batch_size=self._index_batch,
                dtype_name=self.cfg.STORE_DTYPE,
                extensions=self.cfg.SUPPORTED_EXTENSIONS,
                index_folder_name=self.cfg.INDEX_FOLDER_NAME,
                resume=resume,
                rows_per_shard=self.cfg.SHARD_SIZE,
                fast_decode=self.cfg.FAST_DECODE,
                decode_short_side=(
                    self.cfg.DECODE_SHORT_SIDE or self.spec.image_size
                ),
                planar=self.cfg.PLANAR_JPEG,
            )
        with self._cache_lock:
            self._index_cache.pop(_canon(folder), None)
        return count

    def _folder_lock(self, folder: str) -> threading.Lock:
        with self._cache_lock:
            return self._folder_locks.setdefault(_canon(folder), threading.Lock())

    def open_index(self, folder: str) -> IndexReader | None:
        from pathlib import Path

        reader = IndexReader.open(folder, self.cfg.INDEX_FOLDER_NAME)
        if (
            reader is None
            and self.cfg.MIGRATE_LEGACY
            # take the folder lock only when legacy artifacts exist: it is
            # shared with /index runs
            and (Path(folder) / self.cfg.INDEX_FOLDER_NAME / "index.faiss").exists()
        ):
            from .index.legacy import migrate_legacy_index

            with self._folder_lock(folder):
                reader = IndexReader.open(folder, self.cfg.INDEX_FOLDER_NAME)
                if reader is None:
                    migrated = migrate_legacy_index(
                        folder, self.spec.name, self.spec.embed_dim,
                        self.cfg.INDEX_FOLDER_NAME,
                    )
                    # a 0-row legacy index migrates to an empty index
                    if migrated is not None:
                        reader = IndexReader.open(
                            folder, self.cfg.INDEX_FOLDER_NAME
                        )
        return reader

    def _cached_index(self, folder: str):
        """Per-folder search-state cache, invalidated by manifest mtime.
        Returns (entry, reader) or (None, None) when not indexed."""
        from .index.store import index_dir

        key = _canon(folder)
        manifest_path = (
            index_dir(folder, self.cfg.INDEX_FOLDER_NAME) / "manifest.json"
        )
        mtime = None
        # retried once: a publish's two renames leave a short window with
        # no manifest.json
        for attempt in (0, 1):
            try:
                mtime = manifest_path.stat().st_mtime
                break
            except OSError:
                if attempt == 0:
                    time.sleep(0.002)
        with self._cache_lock:
            cached = self._index_cache.get(key)
            if cached is not None and mtime is not None and cached["mtime"] == mtime:
                self._index_cache.move_to_end(key)
                return cached, cached["reader"]
        if mtime is None:
            return None, None
        reader = self.open_index(folder)
        if reader is None:
            return None, None
        if reader.model != self.spec.name:
            log.warning(
                "index in %s was built with model %r but the server runs %r "
                "— results will be wrong until the folder is re-indexed",
                folder, reader.model, self.spec.name,
            )
        with self._cache_lock:
            # stamped with the mtime statted BEFORE open, so a re-index
            # finalizing meanwhile costs one re-open, never a stale entry
            entry = {"mtime": mtime, "reader": reader, "lock": threading.Lock()}
            self._index_cache[key] = entry
            self._index_cache.move_to_end(key)
            while len(self._index_cache) > self._max_cached_folders:
                self._index_cache.popitem(last=False)
        return entry, reader

    def _resolve_kernel(self) -> str:
        """auto -> sharded with more than one visible device, else best;
        xla | pallas | host | sharded as configured."""
        kind = self.cfg.SEARCH_KERNEL
        if kind != "auto":
            return kind
        from .parallel import mesh

        return "sharded" if len(mesh.available_devices(self.device)) > 1 else "best"

    def _corpus_mesh(self):
        """The mesh of the sharded kernel: the first MESH_DEVICES (0 = all)
        of the devices visible to the engine."""
        from .parallel import corpus_mesh, mesh

        return corpus_mesh(self.cfg.MESH_DEVICES, mesh.available_devices(self.device))

    def _per_device_need(self, need: int) -> int:
        """Device bytes per device of a corpus-sized tensor under the
        resolved kernel: the budget is per device, and the sharded kernel
        splits its tensors over the mesh. Divides by MESH_DEVICES as set
        (not by the devices that exist), as the JAX package does."""
        if self._resolve_kernel() != "sharded":
            return need
        from .parallel import mesh

        return need // max(
            self.cfg.MESH_DEVICES or len(mesh.available_devices(self.device)), 1)

    # -- micro-batched serving path --

    def _lazy_batcher(self, attr: str, factory):
        """Double-checked lazy init shared by the batcher properties; every
        batcher is disabled together when MICROBATCH_MS <= 0."""
        inst = self.__dict__.get(attr, _UNSET)
        if inst is not _UNSET:
            return inst
        with self._cache_lock:
            if attr not in self.__dict__:
                self.__dict__[attr] = (
                    None if self.cfg.MICROBATCH_MS <= 0 else factory()
                )
            return self.__dict__[attr]

    @property
    def _batcher(self):
        from .serving import MicroBatcher

        return self._lazy_batcher("_batcher_inst", lambda: MicroBatcher(
            self._execute_search_batch, window_ms=self.cfg.MICROBATCH_MS,
        ))

    @property
    def _host_batcher(self):
        # over-budget folders get their own worker: a host scan takes
        # seconds and must not head-of-line block device searches
        from .serving import MicroBatcher

        return self._lazy_batcher("_host_batcher_inst", lambda: MicroBatcher(
            self._execute_search_batch, window_ms=self.cfg.MICROBATCH_MS,
        ))

    @property
    def _text_batcher(self):
        from .serving import TextEncodeBatcher

        return self._lazy_batcher(
            "_text_batcher_inst", lambda: TextEncodeBatcher(self._encode_tokens)
        )

    @property
    def _fused_batcher(self):
        from .serving import TextSearchBatcher

        return self._lazy_batcher("_fused_batcher_inst", lambda: TextSearchBatcher(
            self._execute_text_search_batch, window_ms=self.cfg.MICROBATCH_MS,
            timers=self.timers,
        ))

    # -- device-memory budget for cached corpora --

    @functools.cached_property
    def _hbm_budget(self):
        """Device-bytes budget, or None = unlimited. HBM_BUDGET_MB > 0 sets
        it; 0 takes 80% of the GPU's memory (unlimited on the CPU)."""
        mb = self.cfg.HBM_BUDGET_MB
        if mb < 0:
            return None
        if mb > 0:
            return mb << 20
        if self.device.type != "cuda":
            return None
        return int(torch.cuda.get_device_properties(self.device).total_memory * 0.8)

    def hbm_snapshot(self) -> dict:
        """Device-byte accounting for /stats."""
        budget = self._hbm_budget
        entries = {}
        with self._cache_lock:
            for key, e in self._index_cache.items():
                entries[key] = {
                    "device_bytes": e.get("device_bytes", 0),
                    "fits_device": e.get("fits_device"),
                    "tiers": [f for f in _DEVICE_TIERS if e.get(f) is not None],
                }
        return {
            "budget_bytes": budget,
            "reserved_bytes": sum(e["device_bytes"] for e in entries.values()),
            "folders": entries,
        }

    def _corpus_device_bytes(self, reader) -> int:
        itemsize = 2 if reader.dtype_name == "bfloat16" else 4
        return reader.count * reader.dim * itemsize

    def _fits_device(self, entry, reader) -> bool:
        """Whether this corpus may ever be materialized on the device;
        cached per entry, the over-budget verdict logged once. The budget
        is per device, so the sharded kernel divides the corpus bytes by
        the mesh size; IVF counts (1 + bucket_factor) x the corpus at the
        store dtype (dense buckets and spill)."""
        fits = entry.get("fits_device")
        if fits is None:
            budget = self._hbm_budget
            need = self._corpus_device_bytes(reader)
            if self.cfg.INDEX_KIND == "ivf":
                need *= 3
            need = self._per_device_need(need)
            fits = budget is None or need <= budget
            if not fits:
                log.warning(
                    "corpus of %d rows (%.2f GB %s) exceeds the device "
                    "budget (%.2f GB) — routing queries to the SQ8 device "
                    "tier (certified int8 sidecar) or the host mmap "
                    "scanner; raise EVOSSEARCH_HBM_BUDGET_MB or shard over "
                    "more cards to search this folder at full dtype on device",
                    reader.count, need / 2**30, reader.dtype_name,
                    budget / 2**30,
                )
            entry["fits_device"] = fits
        return fits

    def _reserve_device_bytes(self, entry, need: int) -> None:
        """Charge ``need`` bytes to ``entry``, evicting OTHER entries'
        device corpora LRU-first until the total fits the budget. Entries
        mid-materialization (lock held) are skipped. Caller holds
        entry['lock']."""
        budget = self._hbm_budget
        with self._cache_lock:
            entry["device_bytes"] = entry.get("device_bytes", 0) + need
            if budget is None:
                return
            total = sum(
                e.get("device_bytes", 0) for e in self._index_cache.values()
            )
            if total <= budget:
                return
            for other in list(self._index_cache.values()):  # LRU-first
                if other is entry or not other.get("device_bytes"):
                    continue
                if not other["lock"].acquire(blocking=False):
                    continue
                try:
                    for field in _DEVICE_TIERS:
                        other.pop(field, None)
                    total -= other["device_bytes"]
                    other["device_bytes"] = 0
                    self.counters.add("hbm_evictions")
                finally:
                    other["lock"].release()
                if total <= budget:
                    return

    def _release_device_bytes(self, entry, need: int) -> None:
        """Roll back a reservation whose materialization failed."""
        with self._cache_lock:
            entry["device_bytes"] = max(0, entry.get("device_bytes", 0) - need)

    def _materialize(self, entry, field: str, need: int, make):
        """``entry[field]``, made once per cache entry by ``make()`` under
        the entry's lock, its ``need`` device bytes reserved first (colder
        folders are evicted before anything lands on the device) and
        released if ``make`` fails. Readers keep a local reference:
        eviction pops the field without the reader holding a lock."""
        value = entry.get(field)
        if value is None:
            with entry["lock"]:
                value = entry.get(field)
                if value is None:
                    self._reserve_device_bytes(entry, need)
                    try:
                        value = make()
                    except BaseException:
                        self._release_device_bytes(entry, need)
                        raise
                    entry[field] = value
        return value

    def _entry_emb(self, entry, reader) -> torch.Tensor:
        """The folder's corpus on the device (bf16 stores as bfloat16)."""
        return self._materialize(entry, "emb", self._corpus_device_bytes(reader),
                                 lambda: self._to_device(reader))

    def _entry_sharded(self, entry, reader):
        """The folder's corpus row-sharded over the mesh, each block read
        straight off the store onto its device (no whole-corpus host
        copy); the budget is per device."""
        from .parallel import ShardedIndex

        mesh = self._corpus_mesh()
        return self._materialize(
            entry, "sharded", self._corpus_device_bytes(reader) // mesh.size,
            lambda: ShardedIndex.from_reader(reader, mesh=mesh))

    def _to_device(self, reader) -> torch.Tensor:
        """Copy the store's shards into one (count, dim) device tensor."""
        bf16 = reader.dtype_name == "bfloat16"
        emb = torch.empty(
            (reader.count, reader.dim),
            dtype=torch.bfloat16 if bf16 else torch.float32,
            device=self.device,
        )
        row = 0
        for shard in reader.shard_arrays():
            host = torch.from_numpy(np.array(shard))  # a writable host copy
            emb[row : row + shard.shape[0]] = (
                host.view(torch.bfloat16) if bf16 else host
            ).to(self.device)
            row += shard.shape[0]
        return emb

    def _entry_ivf(self, entry, reader):
        """The folder's IVF index on the device, loaded from its sidecar or
        built, about (1 + bucket_factor) x the corpus of device bytes."""
        return self._materialize(entry, "ivf", 3 * self._corpus_device_bytes(reader),
                                 lambda: self._load_or_build_ivf(entry, reader))

    def _entry_ivf_any(self, entry, reader):
        """The IVF of the resolved kernel: the mesh-sharded one under
        ``sharded``, the one-device one otherwise (the same search
        contract)."""
        if self._resolve_kernel() == "sharded":
            return self._entry_sharded_ivf(entry, reader)
        return self._entry_ivf(entry, reader)

    def _entry_sharded_ivf(self, entry, reader):
        """The folder's mesh-sharded IVF, loaded or built, about
        (1 + bucket_factor) x the corpus over the mesh per device."""
        mesh = self._corpus_mesh()
        return self._materialize(
            entry, "sharded_ivf", 3 * self._corpus_device_bytes(reader) // mesh.size,
            lambda: self._load_or_build_sharded_ivf(entry, reader, mesh))

    def _load_or_build_sharded_ivf(self, entry, reader, mesh):
        """The mesh-sharded IVF with its own sidecar, ``ivf_mesh{S}.npz``
        (the block layout is specific to the mesh size, which
        ShardedIVFIndex.load checks), under the one-device sidecar's
        staleness rules."""
        from .parallel import ShardedIVFIndex

        ivf_path = reader.root / f"ivf_mesh{mesh.size}.npz"
        ivf = self._load_ivf_sidecar(
            ivf_path, entry, reader,
            lambda p: ShardedIVFIndex.load(p, mesh=mesh),
        )
        if ivf is None:
            ivf = ShardedIVFIndex.build(
                reader.embeddings(), mesh=mesh, nlist=self.cfg.IVF_NLIST,
                pre_normalized=True,
            )
            self.counters.add("ivf_builds")
            try:
                ivf.save(ivf_path)
            except OSError:
                pass  # persistence is an optimization only
        return ivf

    def _load_or_build_ivf(self, entry, reader):
        from .index.ivf import IVFIndex

        ivf_path = reader.root / "ivf.npz"
        ivf = self._load_ivf_sidecar(
            ivf_path, entry, reader,
            lambda p: IVFIndex.load(p, device=self.device),
        )
        if self.device.type == "cuda":
            log.warning(IVF_ON_GPU_WARNING)
        if ivf is None:
            # store rows are unit norm at encode time; the buckets keep
            # the store dtype (bf16 halves the IVF's device bytes)
            emb = self._to_device(reader)
            ivf = IVFIndex.build(
                emb, nlist=self.cfg.IVF_NLIST, pre_normalized=True,
            )
            del emb
            self.counters.add("ivf_builds")
            try:
                ivf.save(ivf_path)
            except OSError:
                pass  # persistence is an optimization only
        return ivf

    def _ivf_want_nlist(self, reader) -> int:
        """Effective nlist, as IVFIndex.build resolves it (0 = auto
        sqrt(n), clamped to n): a sidecar built under an old
        EVOSSEARCH_IVF_NLIST must not pin the setting."""
        want = self.cfg.IVF_NLIST or max(1, int(reader.count ** 0.5))
        return min(want, max(reader.count, 1))

    def _load_ivf_sidecar(self, path, entry, reader, loader):
        """A persisted IVF sidecar iff it is fresh (not older than the
        entry's manifest mtime) and matches the store's row count and the
        current effective nlist; None when absent, stale or mismatched."""
        if not (path.exists() and path.stat().st_mtime >= entry["mtime"]):
            return None
        ivf = loader(path)
        if ivf is not None and (
            ivf.n != reader.count or ivf.nlist != self._ivf_want_nlist(reader)
        ):
            return None
        return ivf

    def _entry_ivf_host(self, entry, reader):
        """Host-resident IVF of an over-budget folder, or None: the
        persisted sidecar loaded with ``host=True`` (numpy, no device
        bytes), so INDEX_KIND=ivf still probes nprobe buckets instead of
        scanning every row. Never builds on a miss: training puts the
        corpus on the device, which an over-budget folder cannot do."""
        if "ivf_host" not in entry:
            with entry["lock"]:
                if "ivf_host" not in entry:
                    from .index.ivf import IVFIndex

                    ivf = self._load_ivf_sidecar(
                        reader.root / "ivf.npz", entry, reader,
                        lambda p: IVFIndex.load(p, host=True),
                    )
                    if ivf is None:
                        log.warning(
                            "INDEX_KIND=ivf but the over-budget folder has "
                            "no matching ivf.npz sidecar — serving the exact "
                            "host scan instead (build the sidecar on a "
                            "device with enough memory, or re-index)",
                        )
                    entry["ivf_host"] = ivf
        return entry["ivf_host"]

    def _ivf_host_search_batch(self, ivf, queries: np.ndarray, k: int):
        """Host IVF probes of a batch, padded to search_batch's contract:
        (Q, k) scores and ids, id -1 and score NEG_INF where the probed
        lists covered fewer than k rows."""
        from .index.ivf import NEG_INF

        nq = queries.shape[0]
        out_s = np.full((nq, k), NEG_INF, np.float32)
        out_i = np.full((nq, k), -1, np.int64)
        for qi in range(nq):
            s, i = ivf.search_host(queries[qi], k, nprobe=self.cfg.IVF_NPROBE)
            out_s[qi, : len(s)] = s
            out_i[qi, : len(i)] = i
        return out_s, out_i

    def _entry_sq8(self, entry, reader):
        """SQ8 capacity tier for an over-budget folder, or None.

        Keeps a certified int8 sidecar (index/sq8.py) on the device —
        half the bf16 corpus bytes — and serves EXACT results through the
        bound-sweep kernel + host rerank, in place of the host scan. The
        sidecar builds host-side (chunked numpy over the mmap shards — an
        over-budget corpus cannot ride through the device) and persists
        next to the store; it is fresh when not older than the manifest
        and stamped with its mtime. Device residency rides the normal
        reservation/eviction accounting."""
        sq8 = entry.get("sq8", _UNSET)
        if sq8 is not _UNSET:
            return sq8
        with entry["lock"]:
            sq8 = entry.get("sq8", _UNSET)
            if sq8 is not _UNSET:
                return sq8
            from .index.sq8 import SQ8Index

            # the sharded kernel row-shards the sidecar over the mesh
            # (SQ8ShardedIndex); the budget is per device
            need = self._per_device_need(reader.count * (reader.dim + 8))
            budget = self._hbm_budget
            if not (
                self.cfg.SQ8 != "off"
                and reader.count
                and reader.dim % 128 == 0
                and (budget is None or need <= budget)
            ):
                entry["sq8"] = None
                return None
            mt = SQ8Index.sidecar_mtime(reader)
            if mt is not None and mt >= entry["mtime"]:
                sq8 = SQ8Index.load(reader, fetch=self.cfg.SQ8_FETCH,
                                    store_mtime=entry["mtime"])
                if sq8 is not None:
                    self._install_sq8(entry, sq8, need)
                    return entry["sq8"]
            if reader.count <= self.cfg.SQ8_SYNC_ROWS:
                log.info(
                    "building the SQ8 sidecar for %d rows (one-time, "
                    "host-side; persisted next to the store)",
                    reader.count,
                )
                try:
                    sq8 = SQ8Index.build_from_reader(
                        reader, fetch=self.cfg.SQ8_FETCH,
                        store_mtime=entry["mtime"],
                    )
                except OSError as e:  # read-only index dir, disk full
                    log.warning("SQ8 sidecar build failed (%s) — "
                                "serving the host scan instead", e)
                    sq8 = None
                if sq8 is not None:
                    self._install_sq8(entry, sq8, need)
                entry.setdefault("sq8", sq8)
                return entry["sq8"]
            # Big corpus, no sidecar yet: a synchronous build would stall
            # this query (and the folder) for minutes — build in the
            # background and serve the host scan until it publishes.
            if not entry.get("sq8_building"):
                entry["sq8_building"] = True
                self.counters.add("sq8_async_builds")
                log.info(
                    "building the SQ8 sidecar for %d rows in the "
                    "background (queries ride the host scan until it is "
                    "ready; EVOSSEARCH_SQ8_SYNC_ROWS forces inline)",
                    reader.count,
                )
                threading.Thread(
                    target=self._build_sq8_background,
                    args=(entry, reader, need), daemon=True,
                    name="sq8-build",
                ).start()
            return None

    def _install_sq8(self, entry, sq8, need: int) -> None:
        """Reserve device bytes and materialize a built/loaded sidecar; on
        a device failure the folder keeps serving via the host scan.
        Caller holds entry['lock']."""
        sq8.counters = self.counters  # uncertified fallbacks -> /stats
        if self._resolve_kernel() == "sharded":
            from .parallel import SQ8ShardedIndex

            sq8 = SQ8ShardedIndex(sq8, self._corpus_mesh())
            materialize = sq8.ensure_device
        else:
            materialize = functools.partial(sq8.ensure_device, self.device)
        self._reserve_device_bytes(entry, need)
        try:
            materialize()
        except Exception as e:
            self._release_device_bytes(entry, need)
            log.warning("SQ8 device materialization failed (%s) — "
                        "serving the host scan instead", e)
            entry["sq8"] = None
            return
        entry["sq8"] = sq8

    def _build_sq8_background(self, entry, reader, need: int) -> None:
        """Daemon-thread sidecar build for corpora over SQ8_SYNC_ROWS.

        Publishes the files, then installs under the entry lock. If the
        folder was re-indexed meanwhile this entry is orphaned (the cache
        keys entries by manifest mtime) and the published sidecar carries
        the OLD store_mtime stamp, so the fresh entry's load() rejects it
        and rebuilds — never stale bounds."""
        from .index.sq8 import SQ8Index

        try:
            sq8 = SQ8Index.build_from_reader(
                reader, fetch=self.cfg.SQ8_FETCH, store_mtime=entry["mtime"]
            )
        except Exception as e:
            log.warning("background SQ8 sidecar build failed (%s) — "
                        "the host scan keeps serving this folder", e)
            with entry["lock"]:
                entry["sq8"] = None
                entry["sq8_building"] = False
            return
        with entry["lock"]:
            try:
                with self._cache_lock:
                    live = any(
                        e is entry for e in self._index_cache.values()
                    )
                if not live:
                    # re-indexed or evicted mid-build: installing device
                    # arrays nobody can reach would only squat memory
                    log.info(
                        "folder changed during the background SQ8 build "
                        "— discarding the stale install (the fresh entry "
                        "rebuilds against the new store)",
                    )
                    entry["sq8"] = None
                    return
                if entry.get("sq8") is not None:
                    # build_from_reader publishes the files BEFORE this
                    # lock is taken: a query thread may already have
                    # loaded and installed them — a second install would
                    # double-reserve device bytes with no release path
                    return
                self._install_sq8(entry, sq8, need)
                if entry.get("sq8") is not None:
                    log.info(
                        "SQ8 sidecar ready: %d rows now served by the "
                        "certified device tier", reader.count,
                    )
            finally:
                entry["sq8_building"] = False

    def _execute_search_batch(self, folder: str, queries, k: int):
        """One batched search over a folder's cached corpus (device
        kernels; for an over-budget corpus the SQ8 tier or the host
        scan)."""
        entry, reader = self._cached_index(folder)
        if reader is None:
            raise LookupError("Folder not indexed")
        k = min(k, reader.count)
        if not self._fits_device(entry, reader):
            # over-budget corpus: the SQ8 tier, else the exact host scan;
            # before the bucket padding (host work is real per row)
            return self._host_search_batch(queries, reader, k, entry)
        from .index.search import query_row_bucket

        # pad the batch to the bucket ladder; extra rows repeat row 0 and
        # their results are sliced away
        q = queries.shape[0]
        pad = query_row_bucket(q)
        if pad > q:
            if isinstance(queries, np.ndarray):
                queries = np.concatenate([
                    queries,
                    np.broadcast_to(queries[:1], (pad - q,) + queries.shape[1:]),
                ])
            else:
                queries = torch.cat([queries, queries[:1].expand(pad - q, -1)])
        s, i = self._execute_search_batch_padded(entry, reader, queries, k)
        return s[:q], i[:q]

    def _host_search_batch(self, queries, reader, k: int, entry=None):
        """Exact scan in place over the mmap shards (SEARCH_KERNEL=host);
        for the over-budget ``entry`` of a folder, the host IVF probe
        (INDEX_KIND=ivf with a matching sidecar) or the SQ8 tier first."""
        from .index.search import exact_search_host_reader_batch

        if isinstance(queries, torch.Tensor):
            queries = queries.cpu().numpy()
        queries = np.asarray(queries, np.float32).reshape(-1, reader.dim)
        self.counters.add("host_routed_queries", queries.shape[0])
        if entry is not None and self.cfg.INDEX_KIND == "ivf":
            ivf = self._entry_ivf_host(entry, reader)
            if ivf is not None:
                self.counters.add("ivf_host_queries", queries.shape[0])
                return self._ivf_host_search_batch(ivf, queries, k)
        sq8 = None if entry is None else self._entry_sq8(entry, reader)
        if sq8 is not None:
            self.counters.add("sq8_queries", queries.shape[0])
            return sq8.search_batch(queries, k)
        return exact_search_host_reader_batch(reader, queries, k)

    def _fused_text_eligible(self, entry, reader) -> bool:
        """Whether a folder's fresh-text searches can take the fused
        encode+search batch: a device kernel over a device-resident
        corpus small enough for the packed float32 index encoding."""
        from .index.search import _PACK_MAX_ROWS

        return (
            self.cfg.INDEX_KIND != "ivf"
            and reader.count < _PACK_MAX_ROWS
            and self._resolve_kernel() in ("xla", "pallas", "best")
            and self._fits_device(entry, reader)
        )

    def _execute_text_search_batch(self, folder: str, tokens, k: int):
        """A batch of fresh-text searches: text tower + corpus top-k with
        one device->host copy of [scores | indices | ok | embeddings]
        (serving.TextSearchBatcher's executor). Returns (scores (B, k'),
        indices (B, k'), embeddings (B, d) float32 numpy)."""
        entry, reader = self._cached_index(folder)
        if reader is None:
            raise LookupError("Folder not indexed")
        k = min(k, reader.count)
        b0 = tokens.shape[0]
        if k == 0 or not self._fused_text_eligible(entry, reader):
            # emptied or re-routed between submit and execution
            emb = self._encode_tokens(tokens).cpu().numpy()
            if k == 0:
                return (
                    np.zeros((b0, 0), np.float32), np.zeros((b0, 0), np.int64),
                    emb,
                )
            s, i = self._execute_search_batch(folder, emb, k)
            return s, i, emb
        from .index.search import (
            _unpack_with_fallback, choose_packed_flavor, packed_topk,
            query_row_bucket,
        )

        pad = query_row_bucket(b0)
        if pad > b0:
            tokens = np.concatenate([
                tokens,
                np.broadcast_to(tokens[:1], (pad - b0,) + tokens.shape[1:]),
            ])
        emb_d = self._entry_emb(entry, reader)
        flavor = choose_packed_flavor(
            reader.count, reader.dim, k, emb_d.dtype, self._resolve_kernel(),
            on_cpu=emb_d.device.type == "cpu",
        )
        q_d = self._encode_tokens(tokens)
        outs = [
            packed_topk(emb_d, q_d[start : start + 128], k, flavor)
            for start in range(0, q_d.shape[0], 128)
        ]
        packed = torch.cat([torch.cat(outs), q_d], dim=1).cpu().numpy()
        s, i = _unpack_with_fallback(packed[:, : 2 * k + 1], emb_d, q_d, k)
        return s[:b0], i[:b0], packed[:b0, 2 * k + 1 :]

    def _execute_search_batch_padded(self, entry, reader, queries, k: int):
        from .index.search import (
            best_exact_search_batch, exact_search_batch, pallas_search_batch,
        )

        if self.cfg.INDEX_KIND == "ivf":
            return self._entry_ivf_any(entry, reader).search_batch(
                queries, k, nprobe=self.cfg.IVF_NPROBE
            )
        kernel = self._resolve_kernel()
        if kernel == "host":
            return self._host_search_batch(queries, reader, k)
        if kernel == "sharded":
            return self._entry_sharded(entry, reader).search_batch(queries, k)
        fn = {
            "pallas": pallas_search_batch,
            "best": best_exact_search_batch,
        }.get(kernel, exact_search_batch)
        return fn(self._entry_emb(entry, reader), queries, k)

    def search_embedding(self, folder: str, query, k: int):
        """Top-k over a folder's index. ``query`` is a (d,) or (1, d) row,
        numpy or a device tensor (the text and image paths hand over device
        rows). Returns (scores, indices, reader) or None when not indexed."""
        entry, reader = self._cached_index(folder)
        if reader is None:
            return None
        k = min(k, reader.count)
        if k == 0:
            return np.zeros((0,), np.float32), np.zeros((0,), np.int64), reader
        if isinstance(query, np.ndarray):
            query = np.asarray(query, np.float32)
        q2d = query if query.ndim == 2 else query[None, :]
        # IVF rows the probes covered short come back padded with id -1
        padded = self.cfg.INDEX_KIND == "ivf"
        with self.timers.stage("search"):
            if not self._fits_device(entry, reader):
                batcher = self._host_batcher
                padded = padded and self._entry_ivf_host(entry, reader) is not None
            elif padded:
                batcher = self._batcher
                # a first-touch build (k-means over the whole corpus) runs
                # in this request thread, not in the batcher's worker,
                # where it would hold up every other folder's searches
                self._entry_ivf_any(entry, reader)
            elif self._resolve_kernel() == "host":
                batcher = None
            else:
                batcher = self._batcher
            if batcher is not None:
                try:
                    scores, idx = batcher.submit(_canon(folder), q2d, k)
                except LookupError:
                    return None  # index vanished before the worker ran
            else:
                s, i = self._execute_search_batch(folder, q2d, k)
                scores, idx = s[0], i[0]
            if padded:
                valid = idx >= 0
                scores, idx = scores[valid], idx[valid]
        self.counters.add("queries")
        return scores, idx, reader

    def stored_embedding(self, folder: str, image_path: str):
        """The stored row embedding of an indexed, UNCHANGED file (same
        mtime and size), or None: the encode that would reproduce it can
        be skipped."""
        entry, reader = self._cached_index(folder)
        if reader is None or not reader.metadata:
            return None
        rows = self._path_rows(entry, reader)
        row = rows.get(str(image_path))
        if row is None:
            row = rows.get(os.path.abspath(image_path))
        if row is None:
            return None
        try:
            st = os.stat(image_path)
        except OSError:
            return None
        meta = reader.metadata[row]
        if meta.get("mtime") != st.st_mtime or meta.get("size") != st.st_size:
            return None
        for shard in reader.shard_arrays():
            if row < shard.shape[0]:
                return np.array(as_float32(shard[row]))  # off the mmap
            row -= shard.shape[0]
        return None

    def search_text(self, folder: str, query: str, k: int):
        """Text query -> top-k over a folder. Fresh texts against
        device-resident corpora ride the fused text->search batcher; cache
        hits and other routes encode, then search."""
        with self._text_cache_lock:
            cached = self._text_cache.get(query)
            if cached is not None:
                self._text_cache.move_to_end(query)
        if cached is not None:
            self.counters.add("text_cache_hits")
            return self.search_embedding(folder, cached, k)
        batcher = self._fused_batcher
        if batcher is None:
            return self.search_embedding(
                folder, self._encode_text_device(query), k
            )
        entry, reader = self._cached_index(folder)
        if reader is None:
            return None
        if reader.count == 0 or not self._fused_text_eligible(entry, reader):
            return self.search_embedding(
                folder, self._encode_text_device(query), k
            )
        tokens = self.tokenizer.tokenize(
            [query], self.spec.context_length, truncate=self.tokenizer.fallback,
        )
        # the batcher splits the stage into search_batch_wait and
        # search_dispatch, which stand on the timeline in its place
        with self.timers.stage("search", enclosing=True):
            try:
                scores, idx, emb_row = batcher.submit(
                    _canon(folder), np.asarray(tokens[0], np.int32),
                    min(k, reader.count),
                )
            except LookupError:
                return None  # index vanished between the check and dispatch
        self.counters.add("texts_encoded")
        self.counters.add("queries")
        self._text_cache_put(query, emb_row)
        return scores, idx, reader

    def search_image(self, folder: str, pil_image, k: int):
        emb = self.encode_image_device(pil_image)
        return self.search_embedding(folder, emb, k)

    def warmup(self) -> None:
        """Run the text and image paths once before serving."""
        with self.timers.stage("warmup"):
            self.encode_text("warmup")
            self.encode_images([np.zeros((64, 64, 3), np.uint8)])
        log.info("engine warmed up (text + image paths)")

    def is_indexed(self, folder: str) -> bool:
        """Authoritative check (full validated open; may migrate legacy)."""
        return self.open_index(folder) is not None

    def is_indexed_fast(self, folder: str) -> bool:
        """Cache-backed check for hot request paths."""
        _, reader = self._cached_index(folder)
        if reader is not None:
            return True
        return self.cfg.MIGRATE_LEGACY and self.is_indexed(folder)

    @staticmethod
    def _path_rows(entry: dict, reader) -> dict:
        """Stored-spelling -> row lookup for a cached index entry."""
        rows = entry.get("path_rows")
        if rows is None:
            rows = {p: r for r, p in enumerate(reader.paths)}
            entry["path_rows"] = rows
        return rows

    def index_contains(self, folder: str, path: str) -> bool | None:
        """Is ``path`` a row of ``folder``'s index (stored or absolute
        spelling)? None when the folder isn't indexed."""
        entry, reader = self._cached_index(folder)
        if reader is None:
            return None
        rows = self._path_rows(entry, reader)
        path = str(path)
        if path in rows:
            return True
        head, name = os.path.split(path)
        if not name or head != _canon(folder):
            return False
        prefixes = entry.get("path_prefixes")
        if prefixes is None:
            prefixes = frozenset(os.path.dirname(p) for p in reader.paths)
            entry["path_prefixes"] = prefixes
        return any(
            (os.path.join(pref, name) if pref else name) in rows
            for pref in prefixes
        )
