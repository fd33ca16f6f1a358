"""The yardstick's arithmetic: the copied FLOP formulas against the
program's bench.py, and the trace reduction on a synthetic trace."""

import pytest

from portbench import flops, trace
from portbench.run import load_cell


@pytest.mark.parametrize("cell,name", [("index.b32.coco640", "ViT-B/32"),
                                       ("index.l14.coco640", "ViT-L/14")])
def test_flops_match_bench(cell, name):
    from evossearch_tpu_torch import bench
    from evossearch_tpu_torch.core.constants import CLIP_MODEL_SPECS

    _, config, _ = load_cell(cell)
    spec = CLIP_MODEL_SPECS[name]
    assert flops.vit_fwd_flops(config["model"]) == bench._vit_fwd_flops(spec)
    assert flops.text_fwd_flops(config["model"]) == bench._text_fwd_flops(spec)
    # the sizes the issue quotes: L/14 about 162 GFLOP an image, B/32 about 8.8
    expect = {"ViT-B/32": 8.8e9, "ViT-L/14": 162e9}[name]
    assert flops.vit_fwd_flops(config["model"]) == pytest.approx(expect, rel=0.02)


def test_config_is_the_programs_spec():
    from evossearch_tpu_torch.core.constants import CLIP_MODEL_SPECS

    for cell in ("index.b32.coco640", "index.l14.coco640"):
        _, config, _ = load_cell(cell)
        spec = CLIP_MODEL_SPECS[config["model"]["name"]]
        for key, value in config["model"].items():
            assert getattr(spec, key) == value, key
        assert config["reduced"] == []


def _ev(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": tid}


def test_trace_reduction():
    events = [
        _ev("kernel", "k1", 100.0, 50.0), _ev("kernel", "k2", 120.0, 60.0),  # overlap
        _ev("gpu_memcpy", "Memcpy DtoH", 300.0, 100.0),
        _ev("kernel", "k1", 1000.0, 40.0),
        _ev("cpu_op", "aten::copy_", 420.0, 500.0),
        _ev("cuda_runtime", "cudaLaunchKernel", 190.0, 5.0),
        {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "x"}},
    ]
    r = trace.reduce_trace(events, window_s=0.002)
    assert r["busy_s"] == pytest.approx((80 + 100 + 40) * 1e-6)
    assert r["window_s"] == 0.002
    assert 100 * (1 - r["busy_s"] / r["window_s"]) == pytest.approx(89.0)
    assert r["kernel_counts"] == {"k1": 2, "k2": 1, "Memcpy DtoH": 1}
    assert r["device_ops"]["k1"] == pytest.approx(90e-6)
    # gaps: 180..300 (the launch overlaps it), 400..1000 (the copy op)
    assert r["idle_gaps"] == [["aten::copy_", pytest.approx(600e-6)],
                              ["cudaLaunchKernel", pytest.approx(120e-6)]]
    assert trace.top_ops(r["device_ops"])[0][0] == "Memcpy DtoH"
