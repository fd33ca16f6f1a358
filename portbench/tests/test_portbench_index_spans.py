"""The readers of the index pipeline's consumer stages: each returns None
on a context shaped like an older program's (which has no such stage),
reads the right value from a synthetic window, and is listed in
BENCHMARK.json for the index cell with its own unit, direction, source,
layer and end-to-end metric."""

import json

import pytest

from portbench import run as bench_run
from portbench.harness import ROOT

CELL = "index.l14.coco640"
# the stages a program without the consumer's spans has in an index window
PARENT_STAGES = ("index_folder", "index_decode", "index_prepare", "prep_encode",
                 "prep_encode_fetch")
# the synthetic window: 3 passes, 12,288 images
STAGES = {"index_fill": (1.8, 3), "index_feed_wait": (0.6144, 24),
          "encode_upload": (15.0, 48), "prep_encode_fetch": (1.5, 24),
          "index_write": (0.1, 24), "index_finalize": (0.0228, 3),
          "index_decode": (10.0, 24)}
IMAGES = 12288
# name: (layer, expected value on the synthetic window)
READERS = {
    "fill_ms_per_pass.index": ("index pipeline", 600.0),
    "feed_wait_ms_per_image.index": ("index pipeline", 0.05),
    "card_wait_ms_per_image.index": ("model step", 1e3 * 16.5 / IMAGES),
    "store_ms_per_image.index": ("index store", 1e3 * 0.1228 / IMAGES),
}


def _ctx(stages: dict) -> dict:
    return {"kind": "index", "images": IMAGES, "elapsed_s": 22.7, "trace": None,
            "model": bench_run.load_cell(CELL)[1]["model"],
            "window": {"stages": {k: {"total_s": t, "count": c} for k, (t, c) in stages.items()},
                       "counters": {}, "fused": {}}}


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader(name):
    layer, expect = READERS[name]
    mod = bench_run.metric_readers()[name]
    parent = _ctx({k: (1.0, 3) for k in PARENT_STAGES})
    assert mod.read(parent) is None
    assert mod.read(_ctx(STAGES)) == pytest.approx(expect, rel=1e-12)
    assert mod.read(dict(_ctx(STAGES), kind="search")) is None
    assert (mod.LAYER, mod.UNIT, mod.BETTER, mod.SOURCE, mod.MOVES) == (
        layer, "ms", "lower", "program_span", "index_card_images_per_s")
    bench = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    (entry,) = [m for m in bench["per_layer"] if m["name"] == name]
    assert entry == {"name": name, "unit": "ms", "better": "lower", "source": "program_span",
                     "layer": layer, "moves": "index_card_images_per_s", "workloads": [CELL]}
    assert bench_run.per_layer(_ctx(STAGES), {"index_card_images_per_s", "setup_s"})[name] == {
        "value": pytest.approx(expect, rel=1e-12), "unit": "ms"}
