"""The port's stage spans (``utils.logging.StageTimer``): the index
pipeline's consumer stages tile each pass, stages reach the
``torch.profiler`` timeline exactly while a profiler records, in the
thread that runs them, stages that enclose others stay off it, and the
fused text->search batcher splits a request's wait into queue and
dispatch."""

import json
import threading
import time

import numpy as np
import pytest
import torch.profiler

from evossearch_tpu_torch.core import Config
from evossearch_tpu_torch.core.constants import CLIPModelSpec
from evossearch_tpu_torch.engine import SearchEngine
from evossearch_tpu_torch.serving import TextSearchBatcher
from evossearch_tpu_torch.utils import StageTimer
from evossearch_tpu_torch.utils.profiling import capture_trace, recording

TINY = CLIPModelSpec(
    name="tiny", image_size=64, patch_size=16, vision_width=64,
    vision_layers=2, vision_heads=4, text_width=48, text_layers=2,
    text_heads=4, vocab_size=49408, context_length=77, embed_dim=32,
)
# the consumer's stages, which tile a pass between them
LEAVES = ("index_open", "index_first_wait", "index_feed_wait", "encode_inputs",
          "encode_upload", "encode_dispatch", "prep_encode_fetch", "index_write",
          "index_finalize")
PRODUCER = ("index_decode", "index_prepare")
ENCLOSING = ("index_folder", "index_fill", "prep_encode")
PASSES, IMAGES, BATCH = 3, 20, 8  # three batches a pass, the last one short


@pytest.fixture()
def folders(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(7)
    out = []
    for p in range(PASSES):
        folder = tmp_path / f"photos{p}"
        folder.mkdir()
        for i in range(IMAGES):
            arr = rng.integers(0, 256, (96, 128, 3), dtype=np.uint8)
            Image.fromarray(arr).save(folder / f"p{i:02d}.jpg", quality=90)
        out.append(str(folder))
    return out


@pytest.fixture()
def engine(tmp_path, monkeypatch):
    for k in ("EVOSSEARCH_CHECKPOINT", "EVOSSEARCH_BPE_VOCAB", "EVOSSEARCH_PROFILE_DIR"):
        monkeypatch.delenv(k, raising=False)
    cfg = Config(env_path=tmp_path / "missing.env")
    cfg.INDEX_BATCH = BATCH
    eng = SearchEngine(cfg=cfg, spec=TINY, device="cpu")
    yield eng
    eng.close()


class _Spy:
    """Stands in for ``torch.profiler.record_function``: records each
    call's name and thread, then enters the real one."""

    real = torch.profiler.record_function

    def __init__(self):
        self.calls = []
        self._lock = threading.Lock()

    def __call__(self, name, args=None):
        with self._lock:
            self.calls.append((name, threading.current_thread().name))
        return self.real(name, args)


@pytest.fixture()
def spy(monkeypatch):
    s = _Spy()
    monkeypatch.setattr(torch.profiler, "record_function", s)
    return s


def _totals(engine) -> dict:
    return {k: (v["total_s"], v["count"]) for k, v in engine.timers.snapshot().items()}


def test_index_stages_tile_each_pass(engine, folders):
    for f in folders:
        assert engine.index_folder(f) == IMAGES
    t = _totals(engine)
    whole = t["index_folder"][0]
    assert t["index_folder"][1] == PASSES
    assert abs(sum(t[k][0] for k in LEAVES) - whole) <= 0.03 * whole
    assert t["index_fill"][1] == PASSES
    assert t["index_fill"][0] < whole
    for k in ("index_open", "index_first_wait", "index_finalize"):
        assert t[k][1] == PASSES, k
    batches = PASSES * -(-IMAGES // BATCH)
    # a later wait per batch and the one that gets the end of the pass
    assert t["index_feed_wait"][1] == batches
    assert t["encode_dispatch"][1] == t["prep_encode_fetch"][1] == batches
    assert t["encode_inputs"][1] == batches
    assert t["index_write"][1] == t["index_decode"][1] == batches
    # prep_encode stays the parent of the uploads and the dispatch
    assert t["prep_encode"][1] == batches
    assert t["encode_upload"][0] + t["encode_dispatch"][0] <= t["prep_encode"][0]


def test_timeline_spans_are_the_leaves_in_their_threads(engine, folders, spy, tmp_path):
    engine.index_folder(folders[0])  # warm, untraced
    assert spy.calls == []
    trace_dir = tmp_path / "traces"
    with capture_trace(str(trace_dir)):
        assert recording()
        for f in folders[1:]:
            engine.index_folder(f)
    assert not recording()
    (trace,) = trace_dir.iterdir()
    events = json.loads(trace.read_text())["traceEvents"]
    annotated = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert set(LEAVES + PRODUCER) <= annotated
    assert not annotated & set(ENCLOSING)

    assert {name for name, _ in spy.calls} == set(LEAVES + PRODUCER)
    for name, thread in spy.calls:
        assert (thread == "index-producer") == (name in PRODUCER), (name, thread)
    # one index_open and one index_finalize a traced pass
    for k in ("index_open", "index_finalize"):
        assert [name for name, _ in spy.calls].count(k) == PASSES - 1, k


def test_no_record_function_without_a_profiler(engine, folders, spy):
    assert not recording()
    engine.index_folder(folders[0])
    assert engine.search_text(folders[0], "a photo", 3) is not None
    assert spy.calls == []
    t = _totals(engine)
    assert t["index_folder"][1] == 1 and t["encode_dispatch"][1] > 0
    assert t["search_dispatch"][1] == 1


def test_fused_search_wait_splits_into_queue_and_dispatch(engine, folders, spy, tmp_path):
    engine.index_folder(folders[0])
    with capture_trace(str(tmp_path / "traces")):
        assert engine.search_text(folders[0], "a red car", 3) is not None
    t = _totals(engine)
    assert t["search"][1] == t["search_batch_wait"][1] == t["search_dispatch"][1] == 1
    assert t["search_batch_wait"][0] + t["search_dispatch"][0] <= t["search"][0]
    (trace,) = (tmp_path / "traces").iterdir()
    events = json.loads(trace.read_text())["traceEvents"]
    annotated = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"search_batch_wait", "search_dispatch"} <= annotated
    assert "search" not in annotated  # it encloses the two
    searched = [n for n, _ in spy.calls if n.startswith("search")]
    assert searched == ["search_batch_wait", "search_dispatch"]


def test_text_search_batcher_times_queue_and_dispatch():
    timers = StageTimer()
    started = threading.Event()

    def execute(folder, tokens, k):
        started.set()
        time.sleep(0.05)
        b = tokens.shape[0]
        return np.zeros((b, k), np.float32), np.zeros((b, k), np.int64), np.zeros((b, 4))

    batcher = TextSearchBatcher(execute, window_ms=0.0, timers=timers)
    try:
        first = threading.Thread(
            target=batcher.submit, args=("f", np.zeros(77, np.int32), 2))
        first.start()
        assert started.wait(5)
        # queued behind the first dispatch, then dispatched itself
        scores, idx, emb = batcher.submit("f", np.zeros(77, np.int32), 2)
        first.join(5)
        assert not first.is_alive()
        assert scores.shape == (2,) and emb.shape == (1, 4)
    finally:
        batcher.close()
    snap = timers.snapshot()
    assert snap["search_batch_wait"]["count"] == snap["search_dispatch"]["count"] == 2
    assert snap["search_batch_wait"]["total_s"] >= 0.02
    assert snap["search_dispatch"]["total_s"] >= 0.09


def test_closing_the_batcher_releases_a_queued_submit():
    timers = StageTimer()
    release = threading.Event()

    def execute(folder, tokens, k):
        release.wait(5)
        b = tokens.shape[0]
        return np.zeros((b, k), np.float32), np.zeros((b, k), np.int64), np.zeros((b, 4))

    batcher = TextSearchBatcher(execute, window_ms=0.0, timers=timers)
    errors = []

    def submit():
        try:
            batcher.submit("f", np.zeros(77, np.int32), 1)
        except RuntimeError as e:
            errors.append(e)

    threads = [threading.Thread(target=submit) for _ in range(2)]
    for th in threads:
        th.start()
        time.sleep(0.05)
    # the second waits in the queue behind the first's dispatch
    batcher._stop = True
    batcher._fail_pending("closed")
    release.set()
    batcher.close()
    for th in threads:
        th.join(5)
        assert not th.is_alive()
    assert len(errors) == 1


def test_stage_reaches_the_timeline_only_while_recording(spy):
    timers = StageTimer()
    with timers.stage("leaf"):
        pass
    assert spy.calls == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with timers.stage("outer", enclosing=True):
            with timers.stage("leaf"):
                pass
        with timers.stage("bare"):
            pass
    assert spy.calls == [("leaf", "MainThread"), ("bare", "MainThread")]
    timers.add("interval", 0.25)
    snap = timers.snapshot()
    assert snap["interval"]["count"] == 1 and snap["interval"]["total_s"] == 0.25
    assert snap["leaf"]["count"] == 2 and snap["outer"]["count"] == 1
