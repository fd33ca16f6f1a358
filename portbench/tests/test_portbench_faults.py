"""A run of each kind of cell, on the CPU at tiny widths and sizes, with
the timed path sound and then broken underneath: the check passes the
sound run and fails every fault the cell can have (an answer altered
where it is produced; half of the batch left out, the rest standing in
for it). The look for a card is skipped; everything else is the run's."""

import time

import numpy as np
import pytest

from portbench import harness, run as bench_run

TINY = dict(image_size=32, patch_size=8, vision_width=64, vision_layers=2, vision_heads=2,
            text_width=32, text_layers=2, text_heads=2, embed_dim=128, name="tiny")


def _run(tmp_path, cell, tamper=None, **traffic):
    workload, config, params = bench_run.load_cell(cell)
    config = dict(config, model=dict(config["model"], **TINY),
                  engine=dict(config["engine"], CLIP_MODEL="tiny"))
    params = dict(params, writers=1, trace_offset_s=0.5, trace_s=1.0, **traffic)
    r = harness.Run(workload=workload, config=config, traffic=params, seed=2**33 + 1,
                    seconds=2.0, trace=False, device="cpu", tmp=tmp_path,
                    started=time.monotonic(), tamper=tamper)
    return bench_run.execute(r, bench_run.traffic_kind(params))


SEARCH = dict(rows=3000, rate=60, photos=8, sample=48)


def _search_fault(fault):
    def tamper(engine):
        inner = engine._execute_text_search_batch

        def broken(folder, tokens, k):
            if fault == "half_batch":
                b = tokens.shape[0]
                s, i, e = inner(folder, tokens[: (b + 1) // 2], k)
                pick = np.arange(b) % s.shape[0]
                return s[pick], i[pick], e[pick]
            s, i, e = inner(folder, tokens, k)
            i = i.copy()
            i[0, 0] = (i[0, 0] + 1) % SEARCH["rows"]
            return s, i, e

        engine._fused_batcher._execute_batch = broken  # the batcher's executor
    return tamper


def test_search_sound_run_passes(tmp_path):
    out = _run(tmp_path, "search.b32.lib1m.fresh", **SEARCH)
    assert out["failed"] == 0 and out["correct"] is True, out["compared"]


@pytest.mark.parametrize("fault", ["answer_altered", "half_batch"])
def test_search_faults_fail(tmp_path, fault):
    out = _run(tmp_path, "search.b32.lib1m.fresh", _search_fault(fault), **SEARCH)
    assert out["correct"] is False, out["compared"]


# every row of a pass is compared at this size, so that the one altered row a
# batch is always among them
INDEX = dict(photos=48, max_passes=3, warm_photos=16, sample_per_pass=48)


class _Ready:
    def __init__(self, emb):
        self.emb = emb

    def resolve(self):
        return self.emb


def _index_fault(fault):
    def tamper(engine):
        inner = engine.encode_prepared_planar

        def broken(*prepared, fetch=True):
            emb = np.array(inner(*prepared, fetch=True))
            if fault == "half_batch":
                half = (emb.shape[0] + 1) // 2
                emb[half:] = emb[: emb.shape[0] - half]
            else:
                emb[0] = -emb[0]
            return _Ready(emb) if not fetch else emb

        engine.encode_prepared_planar = broken
    return tamper


def test_index_sound_run_passes(tmp_path):
    out = _run(tmp_path, "index.l14.coco640", **INDEX)
    assert out["failed"] == 0 and out["correct"] is True, out["compared"]


@pytest.mark.parametrize("fault", ["answer_altered", "half_batch"])
def test_index_faults_fail(tmp_path, fault):
    out = _run(tmp_path, "index.l14.coco640", _index_fault(fault), **INDEX)
    assert out["correct"] is False, out["compared"]
