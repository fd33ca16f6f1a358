"""The index cell's end-to-end rate on the card's clock and its rate on the
host's clock: the card's busy seconds are the union of its spans in a trace
of its activity alone, a run's line leaves out an end-to-end metric that was
not measured (the CPU, a traced run) while the metric still selects the
cell's readers, and the host's rate is a per-layer metric of the cell."""

import json
import textwrap

import pytest

from portbench import harness, run as bench_run
from portbench.harness import ROOT
from portbench.tests.test_portbench_discovery import _run, _tree

CELL = "index.l14.coco640"
NAME = "index_card_images_per_s"


class _FakeProfiler:
    """Writes a Chrome trace of known spans where torch.profiler would."""

    def __init__(self, events):
        self.events, self.stopped = events, False

    def stop(self):
        self.stopped = True

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f)


def _span(cat, ts_us, dur_us, name="op"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts_us, "dur": dur_us}


def test_card_busy_is_the_union_of_device_spans(tmp_path):
    prof = _FakeProfiler([
        _span("kernel", 1000, 1000), _span("kernel", 1500, 1500),  # overlap: 2.0 ms
        _span("gpu_memcpy", 4000, 1000), _span("gpu_memset", 4500, 250),  # 1.0 ms
        _span("cpu_op", 0, 10000), _span("cuda_runtime", 900, 50),  # host: not counted
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 9000},  # no duration
    ])
    run = harness.Run(workload={}, config={}, traffic={}, seed=1, seconds=1.0, trace=False,
                      device="cpu", tmp=tmp_path, started=0.0)
    assert harness.card_busy_s(run, prof) == pytest.approx(3.0e-3, rel=1e-12)
    assert prof.stopped and not list(tmp_path.iterdir())


UNMEASURED = '''
def run(run):
    return {"e2e": {"widgets_per_s": None}, "t0": run.started + 1.5,
            "attempted": 4, "failed": 0, "card": {}, "compared": {"gap": 0.25},
            "problems": [], "ctx": {"kind": "widgets", "busy": 0.5}}
'''


def test_an_unmeasured_end_to_end_metric_is_left_out_but_selects_readers(tmp_path):
    root = _tree(tmp_path)
    (root / "traffic" / "widget_kind.py").write_text(textwrap.dedent(UNMEASURED))
    assert _run(root, trace=False)["metrics"] == {"setup_s": {"value": 1.5, "unit": "s"}}
    assert _run(root, trace=True)["metrics"] == {
        "busy_share.widgets": {"value": 50.0, "unit": "%"}}


def test_the_card_rate_is_the_index_cells_end_to_end_rate():
    bench = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    (entry,) = [m for m in bench["end_to_end"] if m["name"] == NAME]
    assert (entry["unit"], entry["better"], entry["source"], entry["workloads"]) == (
        "images/s", "higher", "device_trace", [CELL])
    assert not [m for m in bench["end_to_end"] if m["name"] == "index_images_per_s"]
    workload = bench_run.load_cell(CELL)[0]
    assert workload["units"] == {NAME: "images/s"}
    for m in bench["per_layer"]:
        if CELL in m["workloads"]:
            assert m["moves"] == NAME, m["name"]


@pytest.mark.parametrize("ctx, expect", [
    ({"kind": "index", "images": 12288, "elapsed_s": 24.0}, 512.0),
    ({"kind": "index", "images": 0, "elapsed_s": 0.0}, None),
    ({"kind": "search", "images": 12288, "elapsed_s": 24.0}, None),
])
def test_host_rate_reader(ctx, expect):
    mod = bench_run.metric_readers()["host_images_per_s.index"]
    assert mod.read(ctx) == expect
    assert (mod.LAYER, mod.UNIT, mod.BETTER, mod.SOURCE, mod.MOVES) == (
        "index pipeline", "images/s", "higher", "host_clock", NAME)
    bench = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    (entry,) = [m for m in bench["per_layer"] if m["name"] == "host_images_per_s.index"]
    assert entry == {"name": "host_images_per_s.index", "unit": "images/s",
                     "better": "higher", "source": "host_clock", "layer": "index pipeline",
                     "moves": NAME, "workloads": [CELL]}
