"""The control: the reference in float8 put in the program's place must
come out as not correct under each cell's limits. On the card it runs at
the cell's own size (``python -m pytest -m gpu portbench/tests``); on the
CPU its arithmetic runs at tiny widths."""

import time

import pytest

from portbench import control, harness, run as bench_run

CELLS = ["search.b32.lib1m.fresh", "search.b32.lib50k.fresh", "index.l14.coco640",
         "index.b32.coco640"]


def _run(cell, tmp_path, device, **over):
    workload, config, traffic = bench_run.load_cell(cell)
    if over:
        config = dict(config, model=dict(config["model"], **over.pop("model")))
        traffic = dict(traffic, **over)
    return harness.Run(workload=workload, config=config, traffic=traffic, seed=2**32 + 17,
                       seconds=30.0, trace=False, device=device, tmp=tmp_path,
                       started=time.monotonic())


def _readings(run):
    if run.traffic["kind"] == "search_open_loop":
        return control.search_readings(run, "fp8")
    return control.index_readings(run, "fp8", 2)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(cell, tmp_path):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    run = _run(cell, tmp_path, "cuda:0")
    ok, shown = bench_run.judge(_readings(run), run.workload["limits"], [])
    assert ok is False, shown


TINY = dict(image_size=32, patch_size=8, vision_width=64, vision_layers=2, vision_heads=2,
            text_width=32, text_layers=2, text_heads=2, embed_dim=64)


@pytest.mark.parametrize("cell", ["search.b32.lib1m.fresh", "index.b32.coco640"])
def test_control_readings_at_tiny_widths(cell, tmp_path):
    over = dict(rows=2000, sample=16) if "search" in cell else dict(sample_per_pass=4)
    run = _run(cell, tmp_path, "cpu", model=TINY, **over)
    got = _readings(run)
    assert all(v > 0 for v in got.values()), got
