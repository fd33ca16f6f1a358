"""Cells, traffic kinds and per-layer metrics are files found by name: a
new one of each, written into a temporary directory, is found and run
with no edit to the harness."""

import json
import textwrap

from portbench import harness, run as bench_run

KIND = '''
def run(run):
    return {"e2e": {"widgets_per_s": 3.0 * run.traffic["widgets"]}, "t0": run.started + 1.5,
            "attempted": 4, "failed": 0, "card": {}, "compared": {"gap": 0.25},
            "problems": [], "ctx": {"kind": "widgets", "busy": 0.5}}
'''
METRIC = '''
LAYER = "widget layer"
UNIT = "%"
BETTER = "higher"
SOURCE = "program_counter"
MOVES = "widgets_per_s"


def read(ctx):
    return 100.0 * ctx["busy"] if ctx["kind"] == "widgets" else None
'''


def _tree(tmp_path):
    for d in ("workloads", "configs", "traffic", "metrics"):
        (tmp_path / d).mkdir()
    (tmp_path / "workloads" / "w.tiny.json").write_text(json.dumps({
        "name": "w.tiny", "config": "cfg-x", "traffic": "mix-x", "chips": 1, "why": "a test",
        "units": {"widgets_per_s": "widgets/s"}, "limits": {"gap": 0.5}}))
    (tmp_path / "configs" / "cfg-x.json").write_text(json.dumps({"model": {}, "engine": {}}))
    (tmp_path / "traffic" / "mix-x.json").write_text(json.dumps({"kind": "widget_kind",
                                                                 "widgets": 2}))
    (tmp_path / "traffic" / "widget_kind.py").write_text(textwrap.dedent(KIND))
    (tmp_path / "metrics" / "busy_share.widgets.py").write_text(textwrap.dedent(METRIC))
    return tmp_path


def _run(root, trace):
    workload, config, traffic = bench_run.load_cell("w.tiny", root)
    r = harness.Run(workload=workload, config=config, traffic=traffic, seed=1, seconds=1.0,
                    trace=trace, device="cpu", tmp=root, started=10.0)
    return bench_run.execute(r, bench_run.traffic_kind(traffic, root), root)


def test_new_cell_kind_and_metric_from_files(tmp_path):
    root = _tree(tmp_path)
    out = _run(root, trace=False)
    assert out["correct"] is True
    assert out["metrics"] == {"widgets_per_s": {"value": 6.0, "unit": "widgets/s"},
                              "setup_s": {"value": 1.5, "unit": "s"}}
    assert list(out)[-1] == "compared"
    out = _run(root, trace=True)
    assert out["metrics"] == {"busy_share.widgets": {"value": 50.0, "unit": "%"}}


def test_limit_decides_correct(tmp_path):
    root = _tree(tmp_path)
    w = json.loads((root / "workloads" / "w.tiny.json").read_text())
    (root / "workloads" / "w.tiny.json").write_text(json.dumps(dict(w, limits={"gap": 0.2})))
    out = _run(root, trace=False)
    assert out["correct"] is False
    assert out["compared"] == {"gap": {"value": 0.25, "limit": 0.2}}


def test_repo_cells_metrics_and_kinds_are_found():
    readers = bench_run.metric_readers()
    assert set(readers) == {
        "card_wait_ms_per_image.index", "decode_ms_per_image.index", "device_idle.index",
        "device_idle.search", "engine_search_ms.search", "feed_wait_ms_per_image.index",
        "fill_ms_per_pass.index", "host_images_per_s.index", "http_host_ms.search", "index_mfu",
        "queries_per_dispatch.search", "search_mfu", "store_ms_per_image.index",
        "topk_roofline.search", "tower_fused_share.index"}
    for name, mod in readers.items():
        assert mod.MOVES in ("search_p95_ms", "index_card_images_per_s"), name
        assert mod.SOURCE in ("device_trace", "program_span", "program_counter",
                              "host_clock"), name
    for cell in ("search.b32.lib1m.fresh", "search.b32.lib50k.fresh",
                 "index.l14.coco640", "index.b32.coco640"):
        workload, config, traffic = bench_run.load_cell(cell)
        assert workload["name"] == cell and workload["chips"] == 1
        assert hasattr(bench_run.traffic_kind(traffic), "run")
