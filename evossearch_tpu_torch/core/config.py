"""Configuration system.

Reproduces the env-var surface of the reference (`EVOSSEARCH_*` prefix,
optional `.env` file, typed defaults, LAN URL discovery, startup banner —
reference config.py:18-99) without the python-dotenv dependency, and adds
TPU-specific knobs (mesh shape, shard size, compute dtype).

The `/settings` endpoint round-trips this config to a generated `.env`
file with the same key set as the reference (oldapp.py:2216-2248).
"""

from __future__ import annotations

import os
from pathlib import Path


def load_env_file(path: str | os.PathLike = ".env", *, override: bool = False) -> dict[str, str]:
    """Minimal .env parser (stand-in for python-dotenv, reference config.py:9-16).

    Lines of the form KEY=VALUE; '#' comments and blank lines ignored;
    surrounding single/double quotes on values stripped. Loaded keys are
    exported into os.environ (existing environment wins unless override).
    """
    path = Path(path)
    loaded: dict[str, str] = {}
    if not path.exists():
        return loaded
    try:
        text = path.read_text(encoding="utf-8")
    except OSError:
        return loaded
    for key, value in _iter_env_lines(text, strip_quotes=True):
        loaded[key] = value
        if override or key not in os.environ:
            os.environ[key] = value
    return loaded


def _iter_env_lines(text: str, *, strip_quotes: bool):
    """The one KEY=VALUE line parser both .env consumers share —
    load_env_file strips surrounding quotes (dotenv semantics) while the
    /settings rewrite preserves raw values verbatim; a future syntax fix
    lands in both through this iterator."""
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        key, _, value = line.partition("=")
        key = key.strip()
        value = value.strip()
        if (
            strip_quotes
            and len(value) >= 2
            and value[0] == value[-1]
            and value[0] in "'\""
        ):
            value = value[1:-1]
        if key:
            yield key, value


def _env_bool(name: str, default: str = "False") -> bool:
    return os.getenv(name, default).lower() in ("true", "1", "yes", "on")


def _env_int(name: str, default: str) -> int:
    try:
        return int(os.getenv(name, default))
    except ValueError:
        return int(default)


def _env_float(name: str, default: str) -> float:
    try:
        return float(os.getenv(name, default))
    except ValueError:
        return float(default)


class Config:
    """Live configuration, snapshot of the environment at construction.

    Same knob inventory as reference config.py:20-45 plus TPU additions.
    """

    def __init__(self, env_path: str | os.PathLike | None = ".env") -> None:
        if env_path is not None:
            load_env_file(env_path)

        # Server configuration (reference config.py:20-22)
        self.HOST = os.getenv("EVOSSEARCH_HOST", "0.0.0.0")
        self.PORT = _env_int("EVOSSEARCH_PORT", "5000")
        self.DEBUG = _env_bool("EVOSSEARCH_DEBUG")

        # CLIP model configuration (reference config.py:25)
        self.CLIP_MODEL = os.getenv("EVOSSEARCH_CLIP_MODEL", "ViT-B/32")

        # Search result limits (reference config.py:28-30)
        self.MIN_RESULTS = _env_int("EVOSSEARCH_MIN_RESULTS", "3")
        self.MAX_RESULTS = _env_int("EVOSSEARCH_MAX_RESULTS", "48")
        self.DEFAULT_RESULTS = _env_int("EVOSSEARCH_DEFAULT_RESULTS", "12")

        # Processing configuration (reference config.py:33-35). Unlike the
        # reference (where BATCH_SIZE is read but never used), BATCH_SIZE here
        # drives the batched device indexing pipeline.
        self.BATCH_SIZE = _env_int("EVOSSEARCH_BATCH_SIZE", "32")
        self.THUMBNAIL_SIZE = (400, 400)
        self.THUMBNAIL_QUALITY = _env_int("EVOSSEARCH_THUMBNAIL_QUALITY", "85")

        # File system configuration (reference config.py:38-39)
        self.INDEX_FOLDER_NAME = os.getenv("EVOSSEARCH_INDEX_FOLDER", ".clip_index")
        self.SUPPORTED_EXTENSIONS = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}

        # Comment system configuration (reference config.py:42)
        self.MAX_COMMENT_LENGTH = _env_int("EVOSSEARCH_MAX_COMMENT_LENGTH", "100")

        # Security configuration (reference config.py:45)
        self.MAX_FILE_SIZE_MB = _env_int("EVOSSEARCH_MAX_FILE_SIZE_MB", "50")

        # --- TPU-native additions (no reference counterpart) ---
        # Compute dtype for encoder matmuls ("bfloat16" or "float32");
        # embeddings/search accumulate in float32 either way.
        self.COMPUTE_DTYPE = os.getenv("EVOSSEARCH_COMPUTE_DTYPE", "bfloat16")
        # Embedding storage dtype in the shard store. bfloat16 by default
        # — the TPU-idiomatic layout: half the shard size AND half the HBM
        # sweep per query (on the JAX package's TPU the tree kernel also
        # ran ~5x faster on bf16 corpora at 1M rows, as f32 corpora pay
        # the 3-pass HIGHEST-precision matmul there; the port's times are
        # in PERF.md). Scores still accumulate f32; set float32 to rank by
        # full-precision embeddings instead.
        self.STORE_DTYPE = os.getenv("EVOSSEARCH_STORE_DTYPE", "bfloat16")
        # Rows per embedding shard file (also the per-device search block).
        self.SHARD_SIZE = _env_int("EVOSSEARCH_SHARD_SIZE", str(1 << 20))
        # Number of mesh devices to shard the corpus over (0 = all available).
        self.MESH_DEVICES = _env_int("EVOSSEARCH_MESH_DEVICES", "0")
        # Data-parallel indexing encode: shard each image batch over the
        # device mesh (>1 device). Per-image math is independent, so
        # results match single-device; disable to pin encode to one chip.
        self.DP_ENCODE = _env_bool("EVOSSEARCH_DP_ENCODE", "True")
        # Native DCT-scaled JPEG decode for indexing (up to ~8x cheaper
        # decode of large photos); disable for bit-parity with PIL decode.
        self.FAST_DECODE = _env_bool("EVOSSEARCH_FAST_DECODE", "True")
        # Short-side floor for DCT-scaled JPEG decode during indexing.
        # 0 = auto: the model's image_size (224 for the 224-px towers) —
        # measured embedding cosine vs full decode 0.999995 on photo-like
        # JPEGs, while ~quartering decode FLOPs and host->device canvas
        # bytes vs the old 2x-image_size floor (the dominant cost on
        # upload-bound hosts). Raise toward 2x image_size for extra
        # resample headroom, or set EVOSSEARCH_FAST_DECODE=0 for full
        # PIL-parity decode.
        self.DECODE_SHORT_SIDE = _env_int("EVOSSEARCH_DECODE_SHORT_SIDE", "0")
        # Indexing pipeline batch (images per fused device dispatch).
        # 0 = auto: max(BATCH_SIZE, 128). BATCH_SIZE (default 32) is the
        # reference-parity serving knob; the indexing pipeline wants
        # bigger dispatches — each one pays the host->device RPC floor
        # and ships the batch's resample matrices, so 4x the batch is
        # ~4x less fixed overhead at ~0.1% of HBM.
        self.INDEX_BATCH = _env_int("EVOSSEARCH_INDEX_BATCH", "0")
        # Planar 4:2:0 JPEG upload for indexing: ship Y + half-res Cb/Cr
        # (1.5 B/px) instead of interleaved RGB (3 B/px) and run chroma
        # resampling + YCbCr->RGB on device — halves the canvas upload,
        # the dominant indexing cost on relay-attached rigs. Disable for
        # bit-parity with the RGB canvas path.
        self.PLANAR_JPEG = _env_bool("EVOSSEARCH_PLANAR_JPEG", "True")
        # Device-memory budget for cached corpora, in MB. 0 = auto: 80% of
        # the GPU's total memory, unlimited on the CPU. Corpora that fit
        # evict colder folders' device arrays LRU-first; corpora that can
        # never fit route to the host scanner instead of crashing
        # mid-request out of device memory. -1 = unlimited.
        self.HBM_BUDGET_MB = _env_int("EVOSSEARCH_HBM_BUDGET_MB", "0")
        # Exact-search kernel: auto | xla | pallas | host | sharded.
        #   auto    = sharded with more than one visible card, else best:
        #             the CUDA candidate kernels for GPU corpora of >= 2^18
        #             rows, the dense exact path below that and on the CPU
        #             (index.search.best_exact_search_batch)
        #   xla     = dense exact product + stable selection (device)
        #   pallas  = the CUDA candidate kernels for every shape they take
        #   host    = exact numpy scan over the mmap store
        #   sharded = the corpus row-sharded over MESH_DEVICES cards, each
        #             block on best's route, merged on the host
        #             (parallel.ShardedIndex)
        self.SEARCH_KERNEL = os.getenv("EVOSSEARCH_SEARCH_KERNEL", "auto")
        # Auto-migrate reference-format .clip_index dirs (FAISS + pickles)
        # to the shard store on first access.
        self.MIGRATE_LEGACY = _env_bool("EVOSSEARCH_MIGRATE_LEGACY", "True")
        # Incremental /index: reuse embeddings of files whose mtime+size is
        # unchanged (the reference re-embeds everything on every /index).
        self.INCREMENTAL_INDEX = _env_bool("EVOSSEARCH_INCREMENTAL_INDEX", "False")
        # Micro-batching window for concurrent searches (ms; 0 disables).
        # Concurrent same-folder queries within the window share one device
        # dispatch (~20x amortization measured on this rig, bench.py).
        self.MICROBATCH_MS = _env_float("EVOSSEARCH_MICROBATCH_MS", "2.0")
        # Index kind: exact (default) or ivf (approximate, >=99% recall@48).
        self.INDEX_KIND = os.getenv("EVOSSEARCH_INDEX_KIND", "exact")
        # IVF probes per query (0 = auto: the recall-calibrated value the
        # build measures — nlist/4 on untuned indexes — raised when needed
        # to cover >=2k candidate rows; see ivf.py); list count (0 = sqrt(N)).
        self.IVF_NPROBE = _env_int("EVOSSEARCH_IVF_NPROBE", "0")
        self.IVF_NLIST = _env_int("EVOSSEARCH_IVF_NLIST", "0")
        # SQ8 capacity tier for over-HBM-budget folders: "auto" keeps an
        # int8 sidecar on device (quarter/half the corpus bytes) and
        # serves certified-EXACT results via device bound-sweep + host
        # rerank (index/sq8.py); "off" falls straight to the host scan.
        self.SQ8 = os.getenv("EVOSSEARCH_SQ8", "auto")
        # Above this row count a missing SQ8 sidecar builds in a
        # background thread (queries ride the host scan until it
        # publishes); at or below it the first query builds inline
        # (~15 s at the threshold on a 1-core host, ~5 min at 20M rows)
        self.SQ8_SYNC_ROWS = _env_int("EVOSSEARCH_SQ8_SYNC_ROWS",
                                      str(1 << 20))
        # Candidate bounds fetched per query by the SQ8 tier (certificate
        # margin; see index.sq8.DEFAULT_FETCH).
        self.SQ8_FETCH = _env_int("EVOSSEARCH_SQ8_FETCH", "512")
        # Path to BPE vocab file (OpenAI bpe_simple_vocab_16e6.txt.gz or HF
        # vocab.json+merges.txt directory); empty = bundled/auto-discovered.
        self.BPE_VOCAB_PATH = os.getenv("EVOSSEARCH_BPE_VOCAB", "")
        # Path to CLIP checkpoint (OpenAI .pt or HF directory); empty = none.
        self.CHECKPOINT_PATH = os.getenv("EVOSSEARCH_CHECKPOINT", "")

    # -- display helpers (contract of reference config.py:47-99) --

    def get_server_urls(self) -> list[str]:
        import socket

        urls = [f"http://localhost:{self.PORT}"]
        if self.HOST == "0.0.0.0":
            try:
                with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
                    s.connect(("8.8.8.8", 80))
                    urls.append(f"http://{s.getsockname()[0]}:{self.PORT}")
            except OSError:
                pass
            try:
                for addr_info in socket.getaddrinfo(socket.gethostname(), None):
                    ip = addr_info[4][0]
                    if ip in ("127.0.0.1", "::1") or ip.startswith("169.254"):
                        continue
                    url = f"http://{ip}:{self.PORT}"
                    if url not in urls:
                        urls.append(url)
            except OSError:
                pass
        return urls

    def print_startup_info(self) -> None:
        print("=" * 60)
        print("evossearch-tpu - TPU-native CLIP Image Search Server")
        print("=" * 60)
        print(f"Host: {self.HOST}")
        print(f"Port: {self.PORT}")
        print(f"Debug: {self.DEBUG}")
        print(f"CLIP Model: {self.CLIP_MODEL}")
        print(f"Result Limits: {self.MIN_RESULTS}-{self.MAX_RESULTS} "
              f"(default: {self.DEFAULT_RESULTS})")
        print(f"Compute dtype: {self.COMPUTE_DTYPE}  Store dtype: {self.STORE_DTYPE}")
        print()
        print("Server available at:")
        for url in self.get_server_urls():
            print(f"  {url}")
        print()
        print("Use Ctrl+C to stop the server")
        print("=" * 60)


_MANAGED_ENV_KEYS = {
    "EVOSSEARCH_HOST", "EVOSSEARCH_PORT", "EVOSSEARCH_DEBUG",
    "EVOSSEARCH_CLIP_MODEL", "EVOSSEARCH_MIN_RESULTS", "EVOSSEARCH_MAX_RESULTS",
    "EVOSSEARCH_DEFAULT_RESULTS", "EVOSSEARCH_BATCH_SIZE",
    "EVOSSEARCH_THUMBNAIL_QUALITY", "EVOSSEARCH_INDEX_FOLDER",
    "EVOSSEARCH_MAX_COMMENT_LENGTH", "EVOSSEARCH_MAX_FILE_SIZE_MB",
}


def _parse_env_file(path: Path) -> dict[str, str]:
    """Parse a .env without touching os.environ; values kept verbatim
    (no quote stripping) so the /settings rewrite preserves them."""
    try:
        text = path.read_text(encoding="utf-8")
    except OSError:
        return {}
    return dict(_iter_env_lines(text, strip_quotes=False))


def write_env_file(settings: dict, path: str | os.PathLike = ".env") -> None:
    """Write the generated .env, same key set as reference oldapp.py:2216-2244.

    `settings` uses the camelCase keys of the /settings JSON contract.
    Keys the settings panel doesn't manage (EVOSSEARCH_CHECKPOINT,
    EVOSSEARCH_BPE_VOCAB, search/TPU knobs, ...) are preserved from the
    existing file — the reference rewrites wholesale, but silently dropping
    the checkpoint path would downgrade the server to random weights on
    the next restart.
    """
    preserved = {
        k: v for k, v in _parse_env_file(Path(path)).items()
        if k not in _MANAGED_ENV_KEYS
    }
    content = f"""# evossearch-tpu Configuration
# Generated by settings panel

# Server Configuration
EVOSSEARCH_HOST={settings['host']}
EVOSSEARCH_PORT={settings['port']}
EVOSSEARCH_DEBUG={str(settings['debug']).lower()}

# CLIP model configuration
EVOSSEARCH_CLIP_MODEL={settings['clipModel']}

# Search result limits
EVOSSEARCH_MIN_RESULTS={settings['minResults']}
EVOSSEARCH_MAX_RESULTS={settings['maxResults']}
EVOSSEARCH_DEFAULT_RESULTS={settings['defaultResults']}

# Processing configuration
EVOSSEARCH_BATCH_SIZE={settings.get('batchSize', 32)}
EVOSSEARCH_THUMBNAIL_QUALITY={settings.get('thumbnailQuality', 85)}

# File system configuration
EVOSSEARCH_INDEX_FOLDER={settings.get('indexFolderName', '.clip_index')}

# Comment system configuration
EVOSSEARCH_MAX_COMMENT_LENGTH={settings.get('maxCommentLength', 100)}

# Security configuration
EVOSSEARCH_MAX_FILE_SIZE_MB={settings.get('maxFileSize', 50)}
"""
    if preserved:
        content += "\n# Preserved settings (not managed by the settings panel)\n"
        for key, value in sorted(preserved.items()):
            content += f"{key}={value}\n"
    Path(path).write_text(content, encoding="utf-8")


# Default module-level instance (reference config.py:102).
config = Config()
