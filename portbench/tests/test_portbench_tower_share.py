"""The reader of the towers' fused share: None on a context shaped like a
program without its counters, the share on a synthetic window, and its
entry in BENCHMARK.json for the index cell."""

import json

import pytest

from portbench import run as bench_run
from portbench.harness import ROOT

CELL = "index.l14.coco640"
NAME = "tower_fused_share.index"


def _ctx(counters: dict, kind: str = "index") -> dict:
    return {"kind": kind, "images": 12288, "elapsed_s": 22.7, "trace": None,
            "model": bench_run.load_cell(CELL)[1]["model"],
            "window": {"stages": {}, "counters": counters, "fused": {}}}


@pytest.mark.parametrize("counters, expect", [
    ({"images_encoded": 12288.0}, None),
    ({"tower_fused_launches": 4104.0}, 100.0),
    ({"tower_fused_launches": 3000.0, "tower_plain_cuda_calls": 1000.0}, 75.0),
    ({"tower_plain_cuda_calls": 170.0}, 0.0),
])
def test_reader(counters, expect):
    mod = bench_run.metric_readers()[NAME]
    got = mod.read(_ctx(counters))
    assert got == (None if expect is None else pytest.approx(expect, rel=1e-12))
    assert mod.read(_ctx(counters, kind="search")) is None
    assert (mod.LAYER, mod.UNIT, mod.BETTER, mod.SOURCE, mod.MOVES) == (
        "model step", "%", "higher", "program_counter", "index_card_images_per_s")


def test_listed_for_the_index_cell():
    bench = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    (entry,) = [m for m in bench["per_layer"] if m["name"] == NAME]
    assert entry == {"name": NAME, "unit": "%", "better": "higher", "source": "program_counter",
                     "layer": "model step", "moves": "index_card_images_per_s", "workloads": [CELL]}
    assert bench_run.per_layer(_ctx({"tower_fused_launches": 10.0}),
                               {"index_card_images_per_s", "setup_s"})[NAME] == {
        "value": 100.0, "unit": "%"}
