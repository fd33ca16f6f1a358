"""The modified ResNet's epilogue readers (``rn_epilogue_share.index``,
``rn_epilogue_roofline.index``) on synthetic contexts: the name rule on
op names the card printed, the share and the roofline worked by hand,
nothing on a ViT context, without a trace or without the counters; and
the RN50x64 configuration and cell found by name, through the harness's
spec and the program's, with their entries in BENCHMARK.json."""

import json

import pytest

from portbench import flops, harness, run as bench_run
from portbench.harness import ROOT
from portbench.metrics import _epilogue

CELL = "index.rn50x64.coco640"
L14 = "index.l14.coco640"
SHARE, ROOFLINE = "rn_epilogue_share.index", "rn_epilogue_roofline.index"

# Device ops as the card named them: the RN50x64 tower's (traced run of
# the cell on an NVIDIA H100 80GB HBM3) and the L/14 tower's, seconds made up.
EPILOGUE_OPS = {
    "void at::native::unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda("
    "at::TensorIteratorBase&)::{lambda()#3}::operator()() const::{lambda()#7}::operator()() "
    "const::{lambda(float)#1}, std::array<char*, 2ul>, 4, TrivialOffsetCalculator<1, unsigned "
    "int>, TrivialOffsetCalculator<1, unsigned int>, at::native::memory::LoadWithCast<1>, "
    "at::native::memory::StoreWithCast<1> >(int, ...)": 0.5,
    "void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<"
    "at::native::CUDAFunctor_add<float> >(at::TensorIteratorBase&, at::native::CUDAFunctor_add"
    "<float> const&)::{lambda(int)#1}>(int, ...)": 0.5,
    "void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<"
    "at::native::BinaryFunctor<float, float, float, at::native::binary_internal::MulFunctor"
    "<float> > >(at::TensorIteratorBase&, ...)::{lambda(int)#1}>(int, ...)": 0.5,
    "void at::native::vectorized_elementwise_kernel<8, at::native::bfloat16_copy_kernel_cuda("
    "at::TensorIteratorBase&)::{lambda(float)#1}, std::array<char*, 2ul> >(int, ...)": 0.25,
    "void at::native::vectorized_elementwise_kernel<8, at::native::(anonymous namespace)::"
    "launch_clamp_scalar(at::TensorIteratorBase&, c10::Scalar, c10::Scalar, at::native::detail"
    "::ClampLimits)::{lambda()#1}::operator()() const::{lambda()#9}::operator()() const::"
    "{lambda(c10::BFloat16)#1}, std::array<char*, 2ul> >(int, ...)": 0.125,
    "void at::native::vectorized_elementwise_kernel<8, at::native::CUDAFunctor_add<"
    "c10::BFloat16>, std::array<char*, 3ul> >(int, at::native::CUDAFunctor_add<c10::BFloat16>, "
    "std::array<char*, 3ul>)": 0.125,
    "void at::native::(anonymous namespace)::avg_pool2d_out_cuda_frame_nhwc<float, float>(int, "
    "float const*, long, long, long, int, int, int, int, int, int, int, int, float*, int, bool, "
    "bool)": 0.0625,
}
OTHER_OPS = {
    "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x256x64_"
    "warpgroupsize2x1x1_g1_execute_segment_k_off_kernel__5x_cudnn": 0.25,
    "cutlass__5x_cudnn::Kernel<cutlass_tensorop_bf16_s16816fprop_optimized_bf16_128x128_32x4_"
    "nhwc_align8>(cutlass_tensorop_bf16_s16816fprop_optimized_bf16_128x128_32x4_nhwc_align8::"
    "Params)": 0.125,
    "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize256x128x8_stage3_warpsize4x2x1_ffma_aligna4_"
    "alignc4_execute_kernel__5x_cublas": 0.125,
    "nvjet_tst_256x128_64x4_2x1_v_bz_coopA_NNT": 0.0625,
    "cutlass_75_wmma_tensorop_bf16_s161616gemm_bf16_32x32_128x1_nn_align8": 0.0625,
    "Memcpy HtoD (Pageable -> Device)": 0.03125,
    "Memcpy DtoH (Device -> Pageable)": 0.03125,
    "Memset (Device)": 0.001,
}


def _trace(counters: dict, busy: float = 4.0) -> dict:
    ops = dict(EPILOGUE_OPS, **OTHER_OPS)
    return {"busy_s": busy, "window_s": 10.0, "device_ops": ops,
            "kernel_counts": {n: 1 for n in ops}, "idle_gaps": [],
            "delta": {"counters": counters, "stages": {}, "fused": {}}}


def _ctx(counters: dict | None, kind: str = "index", cell: str = CELL) -> dict:
    return {"kind": kind, "images": 8192, "elapsed_s": 39.0,
            "trace": None if counters is None else _trace(counters),
            "model": bench_run.load_cell(cell)[1]["model"],
            "window": {"stages": {}, "counters": counters or {}, "fused": {}}}


RN_COUNTERS = {"images_encoded": 2048.0, _epilogue.PASSES: 17216.0,
               _epilogue.BYTES: 0.4 * flops.PEAK_HBM_BYTES_PER_S}


@pytest.mark.parametrize("name", sorted(EPILOGUE_OPS) + sorted(OTHER_OPS))
def test_name_rule(name):
    assert _epilogue.is_epilogue(name) == (name in EPILOGUE_OPS)


def test_share_and_roofline_by_hand():
    # epilogue ops: 0.5 * 3 + 0.25 + 0.125 * 2 + 0.0625 = 2.0625 s of 4.0 s busy
    ctx = _ctx(RN_COUNTERS)
    readers = bench_run.metric_readers()
    assert readers[SHARE].read(ctx) == pytest.approx(100.0 * 2.0625 / 4.0, rel=1e-12)
    # 0.4 s of bytes at the card's bandwidth over 2.0625 s of epilogue ops
    assert readers[ROOFLINE].read(ctx) == pytest.approx(100.0 * 0.4 / 2.0625, rel=1e-12)
    got = bench_run.per_layer(ctx, {"index_card_images_per_s", "setup_s"})
    assert got[SHARE] == {"value": pytest.approx(51.5625), "unit": "%"}
    assert got[ROOFLINE] == {"value": pytest.approx(19.393939393939), "unit": "%"}


@pytest.mark.parametrize("ctx", [
    _ctx({"images_encoded": 2048.0, "tower_fused_launches": 4104.0}, cell=L14),  # a ViT
    _ctx({"images_encoded": 2048.0}),  # a program without the counters
    _ctx({_epilogue.PASSES: 0.0, _epilogue.BYTES: 0.0}),
    _ctx(None),  # no trace (an untraced run)
    _ctx(RN_COUNTERS, kind="search"),
], ids=["vit", "no_counters", "zero", "no_trace", "search"])
def test_nothing_to_read(ctx):
    readers = bench_run.metric_readers()
    for name in (SHARE, ROOFLINE):
        assert readers[name].read(ctx) is None
    assert not {SHARE, ROOFLINE} & set(bench_run.per_layer(
        ctx, {"index_card_images_per_s", "setup_s"}))


def test_readers_declare_their_layers():
    readers = bench_run.metric_readers()
    assert (readers[SHARE].LAYER, readers[SHARE].UNIT, readers[SHARE].BETTER,
            readers[SHARE].SOURCE, readers[SHARE].MOVES) == (
        "model step", "%", "lower", "device_trace", "index_card_images_per_s")
    assert (readers[ROOFLINE].LAYER, readers[ROOFLINE].UNIT, readers[ROOFLINE].BETTER,
            readers[ROOFLINE].SOURCE, readers[ROOFLINE].MOVES) == (
        "kernels", "%", "higher", "device_trace", "index_card_images_per_s")
    assert "_epilogue" not in readers


def test_cell_and_configuration_found_by_name():
    from evossearch_tpu_torch.core import CLIP_MODEL_SPECS

    workload, config, traffic = bench_run.load_cell(CELL)
    assert workload["name"] == CELL and workload["chips"] == 1
    assert workload["units"] == {"index_card_images_per_s": "images/s"}
    assert set(workload["limits"]) == {"cos_gap", "cos_gap_median"}
    assert hasattr(bench_run.traffic_kind(traffic), "run")
    assert harness.model_spec(config["model"]) == CLIP_MODEL_SPECS["RN50x64"]
    assert config["engine"]["CLIP_MODEL"] == "RN50x64" and config["engine"]["INDEX_BATCH"] == 0
    assert config["reduced"] == []
    assert flops.image_fwd_flops(config["model"]) == 520_250_327_040
    engine_cfg = harness.engine_config(config)
    assert engine_cfg.INDEX_BATCH or max(engine_cfg.BATCH_SIZE, 128) == 128
    # the traffic is index_coco640 with only the traced sub-window moved
    base = bench_run.load_json(ROOT, "traffic", "index_coco640")
    assert {k: v for k, v in traffic.items() if base[k] != v} == {
        "trace_offset_s": 6.0, "trace_s": 10.0}
    assert set(traffic) == set(base)


def test_benchmark_entries():
    bench = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    (cfg,) = [c for c in bench["configs"] if c["name"] == "clip-rn50x64"]
    assert cfg["file"] == "portbench/configs/clip-rn50x64.json" and cfg["reduced"] == []
    (cell,) = [w for w in bench["workloads"] if w["name"] == CELL]
    workload = bench_run.load_cell(CELL)[0]
    assert cell == {k: workload[k] for k in ("name", "config", "traffic", "chips", "why")}
    for name, layer, better in ((SHARE, "model step", "lower"), (ROOFLINE, "kernels", "higher")):
        (entry,) = [m for m in bench["per_layer"] if m["name"] == name]
        assert entry == {"name": name, "unit": "%", "better": better, "source": "device_trace",
                         "layer": layer, "moves": "index_card_images_per_s",
                         "workloads": [CELL]}
    listed = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]
              if CELL in m.get("workloads", [])}
    assert "tower_fused_share.index" not in listed
    assert "index_card_images_per_s" in listed
