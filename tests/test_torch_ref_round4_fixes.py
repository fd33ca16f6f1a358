"""The port against tests/test_round4_fixes.py, the round-4 fixes
(VERDICT.md round 3).

Covers:
  * item 5 — /image/ membership is an O(1) probe (engine.index_contains),
    not an O(corpus) dual-spelling frozenset: semantics (stored spelling,
    absolute spelling, non-row 403, unindexed None) plus a structural
    assertion that no full path set is materialized and the row dict
    reuses the reader's own string objects.
  * item 2 — the one-dispatch single-query serving chain: the text
    embedding stays a (1, d) device row end to end, the MicroBatcher
    passes a solo 2-D query through un-stacked, and 1-D/2-D queries give
    identical results on every entry point.

The engine's and the batcher's tests run on the CPU and, marked ``gpu``,
on the card (the ``device`` fixture; the card case skips in its body
without one), where the text and image rows stay on the card and the
batcher stacks card rows. Harness only: the engine is given its device,
the batcher's device rows are torch tensors where the JAX file has
``jnp`` arrays, a device row is read with ``.cpu().numpy()`` where the
JAX file calls ``np.asarray``, and ``test_prepare_batch_canvas_bytes_shrink``
computes its float64 three-operand products with ``np.einsum(...,
optimize=True)`` (two matmuls instead of an unoptimised triple loop; the
same ``atol=1e-9``). Imports neither JAX nor the JAX package.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from evossearch_tpu_torch.core import Config
from evossearch_tpu_torch.core.constants import CLIPModelSpec
from evossearch_tpu_torch.engine import SearchEngine, _canon

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


@pytest.fixture()
def folder(tmp_path):
    rng = np.random.default_rng(0)
    for i in range(3):
        arr = rng.integers(0, 255, (48, 64, 3), np.uint8)
        Image.fromarray(arr).save(tmp_path / f"img_{i}.jpg", quality=90)
    (tmp_path / "secret.txt").write_text("not a row")
    return tmp_path


@pytest.fixture()
def engine(monkeypatch, tmp_path, device):
    for k in ("EVOSSEARCH_CHECKPOINT", "EVOSSEARCH_BPE_VOCAB"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("EVOSSEARCH_COMPUTE_DTYPE", "float32")
    monkeypatch.setenv("EVOSSEARCH_BATCH_SIZE", "4")
    eng = SearchEngine(cfg=Config(env_path=tmp_path / "missing.env"), spec=TINY,
                       device=device)
    yield eng
    eng.close()


# ---- /image/ membership: index_contains --------------------------------


def test_index_contains_semantics(engine, folder):
    engine.index_folder(str(folder))
    stored = engine.open_index(str(folder)).paths
    for p in stored:
        assert engine.index_contains(str(folder), p) is True
        # absolute spelling resolves against the canonical folder
        import os

        abs_p = os.path.join(_canon(str(folder)), os.path.basename(p))
        assert engine.index_contains(str(folder), abs_p) is True
    # files in the indexed folder that are NOT rows stay denied
    assert not engine.index_contains(str(folder), str(folder / "secret.txt"))
    assert not engine.index_contains(str(folder), str(folder / "missing.jpg"))
    # unindexed folder -> None (route answers 403 either way)
    assert engine.index_contains(str(folder / "nope"), "x.jpg") is None


def test_index_contains_relative_stored_spelling(engine, folder, monkeypatch):
    """An index built from a RELATIVE folder path stores relative
    spellings; the absolute spelling /image/ sends must still match."""
    import os

    monkeypatch.chdir(folder.parent)
    rel = folder.name
    engine.index_folder(rel)
    stored = engine.open_index(rel).paths
    assert all(not os.path.isabs(p) for p in stored)
    for p in stored:
        abs_p = os.path.join(_canon(rel), os.path.basename(p))
        assert engine.index_contains(rel, abs_p) is True


def test_index_contains_builds_no_path_set(engine, folder):
    """Structural guard (VERDICT r3 #5): membership must not materialize
    an O(corpus) set of NEW strings. The row dict's keys must BE the
    reader's own path strings (identity, not equality), and no legacy
    'pathset' may appear in the cache entry."""
    engine.index_folder(str(folder))
    # absolute non-row probe: exercises the prefix-join arm
    assert engine.index_contains(str(folder), str(folder / "missing.jpg")) is False
    entry, reader = engine._cached_index(str(folder))
    assert "pathset" not in entry
    rows = entry["path_rows"]
    assert len(rows) == reader.count
    for stored, key in zip(reader.paths, rows):
        assert key is stored  # shared objects — no second string copy
    # the prefix set is tiny (one distinct dirname for a one-folder scan)
    assert len(entry["path_prefixes"]) == 1


def test_image_route_contract_unchanged(engine, folder):
    """The HTTP behavior /image/ pins (tests/test_api_contract.py) in one
    place here: indexed row -> 200, non-row -> 403."""
    from evossearch_tpu_torch.server import TestClient, create_app

    app = create_app(engine=engine, cfg=engine.cfg)
    client = TestClient(app)
    engine.index_folder(str(folder))
    row = str(folder / "img_0.jpg")
    assert client.get(f"/image/{row}").status_code == 200
    assert client.get(f"/image/{folder / 'secret.txt'}").status_code == 403


# ---- one-dispatch single-query chain ------------------------------------


def test_text_embedding_is_2d_device_row(engine, folder):
    emb = engine._encode_text_device("hello world")
    assert getattr(emb, "ndim", None) == 2 and emb.shape[0] == 1
    # public API still returns the (d,) numpy row
    flat = engine.encode_text("hello world")
    assert flat.shape == (TINY.embed_dim,)
    np.testing.assert_allclose(emb.cpu().numpy()[0], flat)


def test_search_embedding_accepts_1d_and_2d(engine, folder):
    engine.index_folder(str(folder))
    q = engine.encode_text("a photo")
    s1, i1, _ = engine.search_embedding(str(folder), q, k=3)
    s2, i2, _ = engine.search_embedding(str(folder), q[None, :], k=3)
    s3, i3, _ = engine.search_embedding(
        str(folder), engine._encode_text_device("a photo"), k=3
    )
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(i1, i3)
    np.testing.assert_allclose(s1, s2, rtol=1e-6)
    np.testing.assert_allclose(s1, s3, rtol=1e-6)


def test_microbatcher_solo_2d_passthrough(device):
    """A solo (1, d) query must reach execute_batch UNTOUCHED — stacking
    or reshaping a device array is an extra eager dispatch on the
    serving hot path."""
    from evossearch_tpu_torch.serving import MicroBatcher

    seen = []

    def execute(folder, queries, k):
        seen.append(queries)
        return (
            np.zeros((queries.shape[0], k), np.float32),
            np.zeros((queries.shape[0], k), np.int64),
        )

    b = MicroBatcher(execute)
    try:
        q2d = torch.ones((1, 8), dtype=torch.float32, device=device)
        b.submit("f", q2d, 2)
        assert seen[-1] is q2d  # identity: no stack, no reshape
        # numpy (d,) rows still get the batched (Q, d) layout
        b.submit("f", np.ones(8, np.float32), 2)
        assert seen[-1].shape == (1, 8)
    finally:
        b.close()


def test_microbatcher_mixed_shapes_stack(device):
    """Mixed (1, d) device + (d,) numpy items in one burst stack into a
    well-formed (Q, d) batch."""
    import threading

    from evossearch_tpu_torch.serving import MicroBatcher

    release = threading.Event()
    shapes = []

    def execute(folder, queries, k):
        if not release.is_set():
            release.wait(5)
        shapes.append(tuple(queries.shape))
        return (
            np.arange(queries.shape[0] * k, dtype=np.float32).reshape(-1, k),
            np.zeros((queries.shape[0], k), np.int64),
        )

    b = MicroBatcher(execute)
    try:
        threads = [
            threading.Thread(target=b.submit, args=("f", q, 2))
            for q in (
                torch.ones((1, 8), dtype=torch.float32, device=device),
                np.ones(8, np.float32),
                torch.zeros((1, 8), dtype=torch.float32, device=device),
            )
        ]
        for t in threads:
            t.start()
        import time

        time.sleep(0.3)  # let the queue accumulate behind the gate
        release.set()
        for t in threads:
            t.join(5)
        assert all(s[1] == 8 and len(s) == 2 for s in shapes)
        assert sum(s[0] for s in shapes) == 3  # every item served once
    finally:
        b.close()


# ---- item 4 — support-window canvas packing -----------------------------


def test_support_window_is_mathematically_exact():
    """Windowed matrices+canvas give the full-matrix result exactly (f64):
    every elided column carries an exact-0.0 weight, so only summation
    order can differ in f32."""
    from evossearch_tpu_torch.preprocess.resize import (
        clip_resize_crop_matrices,
        clip_resize_crop_windowed,
    )

    rng = np.random.default_rng(7)
    for h, w in [(480, 640), (640, 480), (333, 517), (224, 224)]:
        img = rng.integers(0, 256, (h, w), np.uint8).astype(np.float64)
        mh, mw = clip_resize_crop_matrices(h, w, 224)
        full = mh.astype(np.float64) @ img @ mw.T.astype(np.float64)
        wh, ww, y0, x0 = clip_resize_crop_windowed(h, w, 224)
        bh, bw = wh.shape[1], ww.shape[1]
        win = (
            wh.astype(np.float64)
            @ img[y0 : y0 + bh, x0 : x0 + bw]
            @ ww.T.astype(np.float64)
        )
        np.testing.assert_allclose(win, full, rtol=0, atol=1e-9)


def test_support_window_shrinks_cropped_axis():
    """Non-square sources pack a strictly smaller canvas; the square case
    keeps the full frame (no crop -> no zero columns)."""
    from evossearch_tpu_torch.preprocess.resize import clip_resize_crop_windowed

    wh, ww, _, _ = clip_resize_crop_windowed(1080, 1920, 224)
    assert wh.shape[1] == 1080 and ww.shape[1] < 1920 * 0.62
    wh, ww, _, _ = clip_resize_crop_windowed(224, 224, 224)
    assert wh.shape[1] == 224 and ww.shape[1] == 224


def test_prepare_batch_canvas_bytes_shrink():
    """prepare_batch's canvases ride the window ladder, not the source
    ladder: a 16:9 batch uploads ~40% fewer bytes."""
    from evossearch_tpu_torch.preprocess.pipeline import prepare_batch

    rng = np.random.default_rng(3)
    arrays = [rng.integers(0, 256, (360, 640, 3), np.uint8) for _ in range(4)]
    canvases, a_h, a_w, size_idx = prepare_batch(arrays, target=224)
    assert canvases.shape[2] <= 416  # 368-px window padded, far below 640
    # and the result still matches the full-matrix reference
    from evossearch_tpu_torch.preprocess.resize import clip_resize_crop_matrices

    mh, mw = clip_resize_crop_matrices(360, 640, 224)
    ref = np.einsum(
        "th,hwc,sw->tsc", mh, arrays[0].astype(np.float64), mw, optimize=True
    )
    u = size_idx[0]
    got = np.einsum(
        "th,hwc,sw->tsc",
        a_h[u].astype(np.float64),
        canvases[0].astype(np.float64),
        a_w[u].astype(np.float64),
        optimize=True,
    )
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-9)


# ---- deferred-fetch indexing pipeline ------------------------------------


def test_deferred_fetch_matches_sync(engine, folder):
    """encode_prepared(fetch=False).resolve() == encode_prepared(): the
    indexing pipeline's deferred fetch must be bit-identical to the
    synchronous path (same dispatches, fetch merely postponed)."""
    from evossearch_tpu_torch.preprocess import prepare_batch

    rng = np.random.default_rng(5)
    arrays = [rng.integers(0, 256, (48, 64, 3), np.uint8) for _ in range(5)]
    prepared = prepare_batch(arrays, target=TINY.image_size)
    sync = engine.encode_prepared(*prepared)
    pend = engine.encode_prepared(*prepared, fetch=False)
    from evossearch_tpu_torch.engine import PendingEmbeddings

    assert isinstance(pend, PendingEmbeddings)
    np.testing.assert_array_equal(pend.resolve(), sync)


def test_builder_uses_deferred_fetch(engine, folder, monkeypatch):
    """The pipelined build routes every batch through fetch=False (whose
    rows equal the synchronous encode's: test_deferred_fetch_matches_sync),
    and the store holds a row for each image."""
    from evossearch_tpu_torch.index.store import IndexReader

    fetch_args = []
    orig = SearchEngine.encode_prepared_planar

    def spy(self, *a, **kw):
        fetch_args.append(kw.get("fetch", True))
        return orig(self, *a, **kw)

    monkeypatch.setattr(SearchEngine, "encode_prepared_planar", spy)
    orig_rgb = SearchEngine.encode_prepared

    def spy_rgb(self, *a, **kw):
        fetch_args.append(kw.get("fetch", True))
        return orig_rgb(self, *a, **kw)

    monkeypatch.setattr(SearchEngine, "encode_prepared", spy_rgb)
    assert engine.index_folder(str(folder)) == 3
    assert fetch_args and all(f is False for f in fetch_args)
    emb = IndexReader.open(str(folder)).embeddings()
    assert emb.shape == (3, TINY.embed_dim) and np.isfinite(emb).all()


def test_pending_on_device_matches_resolve(engine):
    """PendingEmbeddings.on_device hands over the rows resolve() would copy
    to the host, on the engine's device, and counts them as encoded;
    encode_image_device takes its row so."""
    from evossearch_tpu_torch.preprocess import prepare_batch

    rng = np.random.default_rng(6)
    arrays = [rng.integers(0, 256, (48, 64, 3), np.uint8) for _ in range(3)]
    prepared = prepare_batch(arrays, target=TINY.image_size)
    host = engine.encode_prepared(*prepared, fetch=False).resolve()
    before = engine.counters.snapshot().get("images_encoded", 0)
    rows = engine.encode_prepared(*prepared, fetch=False).on_device()
    assert isinstance(rows, torch.Tensor) and rows.device.type == engine.device.type
    np.testing.assert_array_equal(rows.cpu().numpy(), host)
    assert engine.counters.snapshot()["images_encoded"] == before + 3
    one = engine.encode_image_device(arrays[0])
    assert one.shape == (1, TINY.embed_dim)
    np.testing.assert_array_equal(one.cpu().numpy(), engine.encode_images(arrays[:1]))
    assert engine.counters.snapshot()["images_encoded"] == before + 5


def test_results_json_splice_parses_identically():
    """_results_json splices cached b64 thumbnails into the body without
    re-escaping (a ~2.7 ms/request json.dumps pass on this 1-core host);
    the output must parse to exactly what jsonify would have produced,
    including paths that DO need JSON escaping."""
    import base64
    import copy
    import json

    from evossearch_tpu_torch.server.app import _results_json

    thumb = base64.b64encode(bytes(range(256)) * 200).decode()
    assert "+" in thumb and "/" in thumb and thumb.endswith("=")
    results = [
        {
            "path": 'C:\\photos\\"quoted" — ünïcode\n.jpg',
            "filename": '"quoted" — ünïcode\n.jpg',
            "metadata": {"mtime": 1.5, "size": 42},
            "similarity": 0.987654,
            "thumbnail": thumb,
        },
        {
            "path": "/plain/path.png",
            "filename": "path.png",
            "metadata": {},
            "similarity": -0.25,
            "thumbnail": thumb[:-2],  # unpadded variant
        },
    ]
    expected = {"results": copy.deepcopy(results)}
    resp = _results_json(results)
    assert resp.content_type == "application/json"
    assert json.loads(resp.body.decode("utf-8")) == expected


def test_results_json_empty_list():
    import json

    from evossearch_tpu_torch.server.app import _results_json

    assert json.loads(_results_json([]).body) == {"results": []}


def test_image_search_device_row_equals_fetched_path(engine, folder):
    """search_image rides a device-resident (1, d) embedding row — the
    image twin of the text path's one-blocking-fetch chain. The row must
    be a 2-D non-numpy device array, bit-identical to the fetched
    encode_images output, and the search results must match the classic
    fetch-then-search path exactly."""
    engine.index_folder(str(folder))
    img = Image.open(sorted(folder.glob("*.jpg"))[1])

    row = engine.encode_image_device(img)
    assert not isinstance(row, np.ndarray)
    assert row.ndim == 2 and row.shape[0] == 1
    fetched = engine.encode_images([Image.open(sorted(folder.glob("*.jpg"))[1])])
    np.testing.assert_array_equal(row.cpu().numpy().astype(np.float32), fetched[:1])

    s1, i1, _ = engine.search_image(
        str(folder), Image.open(sorted(folder.glob("*.jpg"))[1]), k=3
    )
    s2, i2, _ = engine.search_embedding(str(folder), fetched[0], k=3)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(s1, s2, rtol=0, atol=0)
