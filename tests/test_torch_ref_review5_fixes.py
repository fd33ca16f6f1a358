"""The port against tests/test_review5_fixes.py, the round-5 review fixes
(the adversarial source review of engine/index/parallel):

1. search_embedding returns None ("not indexed") instead of leaking the
   batcher worker's LookupError as an HTTP 500 when the index vanishes
   between the request thread's check and the worker's re-open — the
   fused text path already had this contract (engine.search_text).
2. Single-device IVF scores with the query quantized to the bucket dtype
   and breaks ties by (score desc, id asc) — the contract every exact
   kernel, the host probe, and the mesh-sharded IVF already follow.
3. The store's resume progress is O(rows) total: per-shard
   ``progress_meta/`` sidecars written once at flush, not the whole
   accumulated paths/metadata list re-serialized on every flush
   (quadratic at multi-million-row corpora). Legacy inline-format
   progress files still resume.

The engine and IVF tests run on the CPU and, marked ``gpu``, on the card
(the ``device`` fixture; the card case skips in its body without one).
Harness only: engines and IVF builds are given their device, the bf16
corpus is a torch tensor where the JAX file has a ``jnp`` array, and
``test_rebuilt_native_loads_fresh_module`` maps the JAX package's
``preprocess/io.py:_load_rebuilt_so`` to the port's design, where a
changed source hashes to a new library path (``native.library_path``),
so ``native.build`` finds the rebuilt file under its own name and
``native.load`` gives a fresh module. Imports neither JAX nor the JAX
package.
"""

import json

import numpy as np
import pytest
import torch

from evossearch_tpu_torch.core import Config
from evossearch_tpu_torch.core.constants import CLIPModelSpec
from evossearch_tpu_torch.engine import SearchEngine
from evossearch_tpu_torch.index import IndexReader, IndexWriter, load_progress
from evossearch_tpu_torch.index.ivf import IVFIndex
from evossearch_tpu_torch.index.search import exact_search_batch

TINY = CLIPModelSpec(
    name="tiny", image_size=64, patch_size=16, vision_width=64,
    vision_layers=2, vision_heads=4, text_width=48, text_layers=2,
    text_heads=4, vocab_size=49408, context_length=77, embed_dim=32,
)


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return request.param


# -- 1. LookupError from the batcher worker -> "not indexed", not 500 ----

def test_search_embedding_vanished_index_returns_none(tmp_path, monkeypatch, device):
    from PIL import Image

    rng = np.random.default_rng(0)
    for i in range(3):
        arr = rng.integers(0, 256, (64, 80, 3), dtype=np.uint8)
        Image.fromarray(arr).save(tmp_path / f"i{i}.jpg", quality=90)
    for k in ("EVOSSEARCH_CHECKPOINT", "EVOSSEARCH_BPE_VOCAB"):
        monkeypatch.delenv(k, raising=False)
    cfg = Config(env_path=None)
    cfg.COMPUTE_DTYPE = "float32"
    cfg.BATCH_SIZE = 4
    cfg.MICROBATCH_MS = 2.0  # batched serving path (worker thread)
    eng = SearchEngine(cfg=cfg, spec=TINY, device=device)
    try:
        eng.index_folder(str(tmp_path))

        # Deterministic stand-in for the race: the worker re-opens the
        # index itself and raises LookupError when it is gone. Patch the
        # executor BEFORE the lazy batcher captures it.
        def vanished(folder, queries, k):
            raise LookupError("Folder not indexed")

        eng._execute_search_batch = vanished
        q = rng.standard_normal(TINY.embed_dim).astype(np.float32)
        q /= np.linalg.norm(q)
        assert eng.search_embedding(str(tmp_path), q, 2) is None
    finally:
        eng.close()


# -- 2. IVF query quantization + tie contract across routes --------------

def _tied_corpus(n=900, d=32, seed=0):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((n, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    # 32 identical rows (> k, < the dense-bucket cap): a tie plateau that
    # lives inside ONE bucket, so every route scores it on one compute
    # path — plateaus straddling the bucket/spill split may differ in the
    # last ulp between the einsum and the spill dot, and exactness is
    # always w.r.t. the scores a path computes (CLAUDE.md)
    emb[:32] = emb[0]
    return emb


def test_ivf_device_matches_host_on_ties(device):
    corpus = _tied_corpus()
    ivf = IVFIndex.build(corpus, nlist=16, iters=4, tune_target=None,
                         device=device)
    q = corpus[0] + np.float32(1e-4)
    q /= np.linalg.norm(q)
    k = 12
    ds, di = ivf.search(q, k, nprobe=ivf.nlist)
    hs, hi = ivf.search_host(q, k, nprobe=ivf.nlist)
    # the duplicates tie at the top: both routes must return the
    # lowest-id members in id order, not probe/bucket-position order
    assert np.array_equal(np.asarray(di), hi), (di, hi)
    assert np.allclose(np.asarray(ds), hs, atol=1e-6)
    assert np.array_equal(np.asarray(di), np.arange(k))


def test_ivf_full_probe_equals_exact_on_bf16(device):
    rng = np.random.default_rng(3)
    corpus = rng.standard_normal((800, 32)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    emb16 = torch.from_numpy(corpus).to(device, torch.bfloat16)
    ivf = IVFIndex.build(emb16, nlist=8, iters=4, tune_target=None)
    assert ivf.buckets.dtype == torch.bfloat16
    queries = rng.standard_normal((4, 32)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    es, ei = exact_search_batch(emb16, queries, 10)
    vs, vi = ivf.search_batch(queries, 10, nprobe=ivf.nlist)
    # full probe must reproduce the exact kernel's results — requires the
    # query quantized to the bucket dtype exactly like the exact kernels
    assert np.array_equal(np.asarray(vi), np.asarray(ei))
    assert np.allclose(np.asarray(vs), np.asarray(es), atol=2e-6)


# -- 3. per-shard resume progress ---------------------------------------

def _write_rows(w, n, dim, seed):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((n, dim)).astype(np.float32)
    paths = [f"/x/p{seed}_{i}.jpg" for i in range(n)]
    meta = [{"path": p, "mtime": 1.0, "size": 1} for p in paths]
    w.append(emb, paths, meta)
    return paths


def test_progress_is_per_shard_not_inline(tmp_path):
    dim = 8
    w = IndexWriter.create(tmp_path, model="t", dim=dim, rows_per_shard=10)
    p1 = _write_rows(w, 25, dim, seed=1)  # 2 full shards + 5 tail rows
    root = w.root
    prog = json.loads((root / "progress.json").read_text())
    assert "done_paths" not in prog  # header only — no O(n) re-serialize
    assert sum(s["rows"] for s in prog["shards"]) == 20
    metas = sorted((root / "progress_meta").glob("meta_*.json"))
    assert len(metas) == 2
    assert len(json.loads(metas[0].read_text())["paths"]) == 10

    # resume covers exactly the flushed rows, in order
    assert set(load_progress(tmp_path)) == set(p1[:20])
    w2 = IndexWriter.resume(tmp_path, model="t", dim=dim)
    assert w2 is not None and w2.count == 20
    assert w2._paths == p1[:20]

    # finish the run: the published index has no progress droppings
    _write_rows(w2, 4, dim, seed=2)
    w2.finalize()
    reader = IndexReader.open(tmp_path)
    assert reader is not None and reader.count == 24
    assert not (reader.root / "progress_meta").exists()
    assert not (reader.root / "progress.json").exists()


def test_progress_legacy_inline_format_still_resumes(tmp_path):
    import shutil

    dim = 8
    w = IndexWriter.create(tmp_path, model="t", dim=dim, rows_per_shard=10)
    p1 = _write_rows(w, 20, dim, seed=4)
    root = w.root
    # rewrite the progress file in the legacy inline format
    prog = json.loads((root / "progress.json").read_text())
    prog["done_paths"] = p1
    prog["metadata"] = [{"path": p, "mtime": 1.0, "size": 1} for p in p1]
    (root / "progress.json").write_text(json.dumps(prog))
    shutil.rmtree(root / "progress_meta")

    assert set(load_progress(tmp_path)) == set(p1)
    w2 = IndexWriter.resume(tmp_path, model="t", dim=dim)
    assert w2 is not None and w2.count == 20 and w2._paths == p1


def test_progress_missing_sidecar_means_no_resume(tmp_path):
    import shutil

    dim = 8
    w = IndexWriter.create(tmp_path, model="t", dim=dim, rows_per_shard=10)
    _write_rows(w, 20, dim, seed=5)
    shutil.rmtree(w.root / "progress_meta")  # sidecars lost -> no resume
    assert IndexWriter.resume(tmp_path, model="t", dim=dim) is None
    assert load_progress(tmp_path) == set()


# -- 4. palette-mode thumbnails get the requested LANCZOS filter ----------

def test_palette_png_thumbnail_is_lanczos_not_nearest(tmp_path):
    import base64
    from io import BytesIO

    from PIL import Image

    from evossearch_tpu_torch.server import thumbs

    rng = np.random.default_rng(0)
    rgb = Image.fromarray(
        rng.integers(0, 256, (800, 800, 3), dtype=np.uint8)
    )
    p = rgb.convert("P", palette=Image.Palette.ADAPTIVE)
    path = tmp_path / "pal.png"
    p.save(path)

    out = base64.b64decode(thumbs._render(str(path), (400, 400), 85))
    got = np.asarray(Image.open(BytesIO(out)).convert("RGB"), np.float32)

    # oracle: convert FIRST, then LANCZOS thumbnail, same JPEG encode
    ref = Image.open(path).convert("RGB")
    ref.thumbnail((400, 400), Image.Resampling.LANCZOS)
    buf = BytesIO()
    ref.save(buf, format="JPEG", quality=85)
    want = np.asarray(
        Image.open(BytesIO(buf.getvalue())).convert("RGB"), np.float32
    )
    assert np.array_equal(got, want)
    # and it is NOT the nearest-neighbor downscale Pillow silently
    # substitutes for P-mode inputs
    nearest = np.asarray(
        Image.open(path).resize((400, 400), Image.Resampling.NEAREST)
        .convert("RGB"),
        np.float32,
    )
    assert np.abs(got - nearest).mean() > 1.0


# -- 5. BPE cache is bounded ---------------------------------------------

def test_bpe_cache_is_bounded():
    from evossearch_tpu_torch.tokenizer.bpe import CLIPTokenizer

    tok = CLIPTokenizer()  # byte-fallback mode
    tok._BPE_CACHE_CAP = 8
    for i in range(50):
        tok.encode(f"word{i}")
    assert len(tok._bpe_cache) <= 8 + 1  # cap, +1 for the post-reset insert
    # specials survive the reset
    assert "<|endoftext|>" in tok._bpe_cache
    # correctness unaffected by eviction
    assert tok.encode("word3") == tok.encode("word3")


# -- 7. hidden files are not indexed (reference glob.glob parity) ---------

def test_scan_folder_skips_hidden_files(tmp_path):
    from PIL import Image

    from evossearch_tpu_torch.index.builder import scan_folder

    rng = np.random.default_rng(0)
    arr = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
    Image.fromarray(arr).save(tmp_path / "visible.jpg")
    Image.fromarray(arr).save(tmp_path / ".hidden.jpg")
    (tmp_path / "._IMG_0001.jpg").write_bytes(b"AppleDouble junk")
    names = [p.name for p in scan_folder(tmp_path)]
    assert names == ["visible.jpg"]


# -- 8. legacy metadata entries must be dict-shaped or synthesized --------

def test_legacy_migration_synthesizes_malformed_metadata(tmp_path):
    import pickle

    from evossearch_tpu_torch.index.legacy import migrate_legacy_index
    from tests.test_torch_ref_legacy_migration import _write_faiss_flat

    rng = np.random.default_rng(0)
    emb = rng.standard_normal((4, 8)).astype(np.float32)
    root = tmp_path / ".clip_index"
    root.mkdir()
    _write_faiss_flat(root / "index.faiss", emb)
    paths = [str(tmp_path / f"i{i}.jpg") for i in range(4)]
    (root / "paths.pkl").write_bytes(pickle.dumps(paths))
    # malformed entries: right length, wrong shape (tuples, not dicts)
    (root / "metadata.pkl").write_bytes(
        pickle.dumps([(p, 1.0, 2) for p in paths])
    )
    assert migrate_legacy_index(tmp_path, model_name="t") == 4
    from evossearch_tpu_torch.index import IndexReader

    reader = IndexReader.open(tmp_path)
    # synthesized dict metadata — downstream m["path"] subscripts work
    assert all(m["path"] for m in reader.metadata)


# -- 9. batcher submit after close fails fast, never hangs ----------------

def test_batcher_submit_after_close_raises():
    from evossearch_tpu_torch.serving import MicroBatcher

    mb = MicroBatcher(lambda folder, q, k: (np.zeros((q.shape[0], k)),) * 2)
    mb.close()
    with pytest.raises(RuntimeError, match="closed"):
        mb.submit("f", np.zeros(4, np.float32), 2)


# -- 6. stale-native rebuild loads the NEW binary ------------------------

def test_rebuilt_native_loads_fresh_module(tmp_path, monkeypatch):
    import shutil
    import sys

    from evossearch_tpu_torch import native as native_build
    from evossearch_tpu_torch.preprocess.io import get_native

    native = get_native()
    if native is None:
        pytest.skip("native ext unavailable")
    # an edited source: the port names its library by a hash of the
    # source, so the rebuild lands beside the old file under a new name
    # (here a copy of the built library stands in for g++'s output)
    old = native_build.build(compile=False)["library"]
    edited = tmp_path / native_build.SOURCE.name
    edited.write_bytes(native_build.SOURCE.read_bytes() + b"\n// edited\n")
    monkeypatch.setattr(native_build, "SOURCE", edited)
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "_build")
    info = native_build.build(compile=False)
    assert info["library"] is None  # not yet rebuilt
    _, target = native_build.probe()
    lib = native_build.pillow_libjpeg() if info["route"] == "pillow" else None
    rebuilt = native_build.library_path(info["route"], target, lib)
    assert rebuilt.name != old.name
    rebuilt.parent.mkdir()
    shutil.copy(old, rebuilt)
    info = native_build.build(compile=False)
    assert info["library"] == rebuilt
    monkeypatch.setitem(sys.modules, native_build.MODULE_NAME, native)
    fresh = native_build.load(info["library"])
    # a fresh module object (the (name, path) extension cache was
    # defeated), with the planar API present
    assert fresh is not native
    assert hasattr(fresh, "decode_jpeg_planar_batch")
