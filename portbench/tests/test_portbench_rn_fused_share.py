"""The reader of the ResNet epilogues' fused share: None on a context
shaped like a program without its counters (the parent's, or a ViT
tower's), the share on a synthetic window, and its entry in
BENCHMARK.json for the RN50x64 cell."""

import json

import pytest

from portbench import run as bench_run
from portbench.harness import ROOT

CELL = "index.rn50x64.coco640"
NAME = "rn_epilogue_fused_share.index"


def _ctx(counters: dict, kind: str = "index") -> dict:
    return {"kind": kind, "images": 4096, "elapsed_s": 20.1, "trace": None,
            "model": bench_run.load_cell(CELL)[1]["model"],
            "window": {"stages": {}, "counters": counters, "fused": {}}}


@pytest.mark.parametrize("counters, expect", [
    ({"images_encoded": 4096.0}, None),
    ({"images_encoded": 4096.0, "rn_epilogue_passes": 34432.0}, None),
    ({"tower_fused_launches": 4104.0}, None),
    ({"rn_epilogue_fused_launches": 6336.0}, 100.0),
    ({"rn_epilogue_fused_launches": 594.0, "rn_epilogue_plain_cuda_calls": 198.0}, 75.0),
    ({"rn_epilogue_plain_cuda_calls": 198.0}, 0.0),
])
def test_reader(counters, expect):
    mod = bench_run.metric_readers()[NAME]
    got = mod.read(_ctx(counters))
    assert got == (None if expect is None else pytest.approx(expect, rel=1e-12))
    assert mod.read(_ctx(counters, kind="search")) is None
    assert (mod.LAYER, mod.UNIT, mod.BETTER, mod.SOURCE, mod.MOVES) == (
        "kernels", "%", "higher", "program_counter", "index_card_images_per_s")


def test_listed_for_the_rn50x64_cell():
    bench = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    (entry,) = [m for m in bench["per_layer"] if m["name"] == NAME]
    assert entry == {"name": NAME, "unit": "%", "better": "higher", "source": "program_counter",
                     "layer": "kernels", "moves": "index_card_images_per_s", "workloads": [CELL]}
    assert bench["per_layer"][-1] == entry
    got = bench_run.per_layer(_ctx({"rn_epilogue_fused_launches": 198.0}),
                              {"index_card_images_per_s", "setup_s"})
    assert got[NAME] == {"value": 100.0, "unit": "%"}
