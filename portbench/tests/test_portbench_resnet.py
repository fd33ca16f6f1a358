"""The benchmark takes a configuration of either CLIP family from its data
files alone: the ViT weights as before, bit for bit; the modified ResNet's
seeded layout against the program's module; its FLOPs against the
program's bench; its plain reference against the program's tower on the
CPU; and a whole index run of a tiny ResNet configuration written only
as files."""

import dataclasses
import hashlib
import json
import shutil
import time

import numpy as np
import pytest
import torch

from portbench import data, flops, harness, run as bench_run
from portbench.reference import clip, resnet

# Digests of each ViT configuration's weight_layout (names, shapes, means,
# stds, in order) and of a tiny ViT's seeded weights, taken on the tree
# before the resnet family was added: the ViT cells draw the same weights.
VIT_LAYOUTS = {
    "clip-vit-l14": (446, "82503aa3b6b9c8a876ed624d5de65488c415323505b7b7b258c022cad090de53"),
    "clip-vit-b32": (302, "af10300b3e1cd7179f45662621d63d81bf7eb562a69400fa7db20906c35e9770"),
}
TINY_VIT = dict(name="tiny", image_size=32, patch_size=8, vision_width=16, vision_layers=2,
                vision_heads=2, text_width=16, text_layers=2, text_heads=2, vocab_size=49408,
                context_length=77, embed_dim=8)
TINY_VIT_WEIGHTS = "78c4ce1c524e49e194982fd54910163443da5c71a6e5629468055d31d8c7a302"
# ViT-L/14's image tower as index_mfu counts it, on the tree before.
L14_IMAGE_FLOPS = 162_026_741_760

SMALL = dict(name="small", family="resnet", image_size=64, vision_width=16,
             vision_layers=[1, 2, 2, 1], vision_heads=8, text_width=16, text_layers=1,
             text_heads=2, vocab_size=49408, context_length=77, embed_dim=32)
# bf16 rounds the operands and the output of every conv (2**-9 relative
# each) while BatchNorm and the attention pool stay float32, and at
# SMALL's 8-64 channels little of that averages out: six seeds read
# 2.6e-4 - 6.0e-4 on photo-like images (the fp8 reference 0.044 - 0.086),
# and this leaves three times that.
BF16_GAP = 2e-3


def _photos(model, seed, n=8):
    """Photo-like images as the calibration batch is made, from another
    seed."""
    return data.calibration_images(model, 1000 + seed, "cpu")[:n]


def _rn_specs():
    from evossearch_tpu_torch.core.constants import CLIP_MODEL_SPECS

    return {n: s for n, s in CLIP_MODEL_SPECS.items() if s.family == "resnet"}


RN_NAMES = ["RN50", "RN101", "RN50x4", "RN50x16", "RN50x64"]


def _model(spec) -> dict:
    return dict(dataclasses.asdict(spec), family=spec.family)


def _cos_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((1 - (a.double() * b.double()).sum(-1)).max())


@pytest.mark.parametrize("config", sorted(VIT_LAYOUTS))
def test_vit_layouts_unchanged(config):
    model = json.loads((harness.ROOT / "configs" / f"{config}.json").read_text())["model"]
    layout = data.weight_layout(model)
    digest = hashlib.sha256(json.dumps([[n, list(s), m, sd] for n, s, m, sd in layout])
                            .encode()).hexdigest()
    assert (len(layout), digest) == VIT_LAYOUTS[config]


def test_vit_weights_bit_identical():
    h = hashlib.sha256()
    for k, v in data.make_weights(TINY_VIT, 2**32 + 17, "cpu").items():
        h.update(k.encode())
        h.update(v.contiguous().numpy().tobytes())
    assert h.hexdigest() == TINY_VIT_WEIGHTS


def test_rn_spec_table_is_the_one_tested():
    assert sorted(_rn_specs()) == sorted(RN_NAMES)


@pytest.mark.parametrize("name", RN_NAMES)
def test_resnet_layout_is_the_programs_state_dict(name):
    from evossearch_tpu_torch.models import CLIP

    spec = _rn_specs()[name]
    with torch.device("meta"):
        module = CLIP(spec)
    want = [(k, tuple(v.shape)) for k, v in module.state_dict().items()]
    got = [(n, tuple(s)) for n, s, _, _ in data.weight_layout(_model(spec))]
    assert sorted(got) == sorted(want)
    assert len(got) == len(set(got))


@pytest.mark.parametrize("name", RN_NAMES)
def test_resnet_flops_match_bench(name):
    from evossearch_tpu_torch import bench

    spec = _rn_specs()[name]
    assert flops.resnet_fwd_flops(_model(spec)) == bench._resnet_fwd_flops(spec)
    assert flops.image_fwd_flops(_model(spec)) == bench.image_fwd_flops(spec)


def test_l14_image_flops_unchanged():
    _, config, _ = bench_run.load_cell("index.l14.coco640")
    assert flops.image_fwd_flops(config["model"]) == L14_IMAGE_FLOPS
    mfu = bench_run.metric_readers()["index_mfu"]
    ctx = {"kind": "index", "images": 1000, "elapsed_s": 2.0, "model": config["model"]}
    assert mfu.read(ctx) == 100.0 * 1000 * L14_IMAGE_FLOPS / (2.0 * flops.PEAK_BF16_FLOPS)


def test_model_spec_builds_both_families():
    from evossearch_tpu_torch.core.constants import (CLIP_MODEL_SPECS, CLIPModelSpec,
                                                      CLIPResNetSpec)

    _, config, _ = bench_run.load_cell("index.l14.coco640")
    assert harness.model_spec(config["model"]) == CLIP_MODEL_SPECS["ViT-L/14"]
    spec = harness.model_spec(SMALL)
    assert isinstance(spec, CLIPResNetSpec) and not isinstance(spec, CLIPModelSpec)
    assert spec.vision_layers == (1, 2, 2, 1) and spec.attn_dim == 512
    assert harness.model_spec(_model(_rn_specs()["RN50x64"])) == _rn_specs()["RN50x64"]
    with pytest.raises(ValueError):
        harness.model_spec(dict(SMALL, family="convnext"))


def test_resnet_batchnorm_statistics_are_the_calibration_batchs():
    w = data.make_weights(SMALL, 3, "cpu")
    cal = data.calibration_images(SMALL, 3, "cpu").permute(0, 3, 1, 2)
    x = torch.nn.functional.conv2d(cal, w["visual.stem.conv1.kernel"].permute(3, 2, 0, 1),
                                   stride=2, padding=1)
    torch.testing.assert_close(w["visual.stem.bn1.mean"], x.mean((0, 2, 3)))
    torch.testing.assert_close(w["visual.stem.bn1.var"], x.var((0, 2, 3), unbiased=False))
    var = torch.cat([v for k, v in w.items() if k.endswith(".var")])
    mean = torch.cat([v for k, v in w.items() if k.endswith(".mean")])
    assert var.min() > 0 and float((var - 1).abs().median()) > 0.1  # far from identity
    assert float(mean.abs().median()) > 0.05
    # no block's last scale is zero, as OpenAI's init would have it
    for p, _ in resnet.blocks(SMALL):
        assert float(w[p + ".bn3.scale"].abs().min()) > 0.1, p


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_program_resnet_tower_against_the_reference(seed):
    from evossearch_tpu_torch.models import CLIP, encode_image

    w = data.make_weights(SMALL, seed, "cpu")
    module = CLIP(harness.model_spec(SMALL))
    module.load_state_dict(w, strict=True)
    module.eval()
    px = _photos(SMALL, seed)
    ref = clip.encode_image(w, px, SMALL)
    assert _cos_gap(encode_image(module, px, torch.float32), ref) <= 1e-6
    assert _cos_gap(encode_image(module, px, torch.bfloat16), ref) <= BF16_GAP
    assert _cos_gap(clip.encode_image(w, px, SMALL, "fp8"), ref) > BF16_GAP


@pytest.mark.parametrize("block", ["visual.stage3.rest.0", "visual.stage4.down"])
def test_a_late_blocks_conv_moves_the_output(block):
    """A 20% change to a late block's conv2 kernel moves the reference's
    output past the bf16 gap (four seeds: a 20% change moved it by 1.1e-2 -
    3.3e-2, a 10% change by 2.8e-3 - 8.4e-3, a 1% change by 2.8e-5 -
    9.9e-5, below bf16's rounding). With
    OpenAI's zeroed last BatchNorm scale the same change would move
    nothing."""
    w = data.make_weights(SMALL, 4, "cpu")
    px = _photos(SMALL, 4)
    ref = clip.encode_image(w, px, SMALL)
    key = block + ".conv2.kernel"
    assert _cos_gap(clip.encode_image(dict(w, **{key: w[key] * 1.2}), px, SMALL), ref) > BF16_GAP
    zeroed = dict(w, **{block + ".bn3.scale": torch.zeros_like(w[block + ".bn3.scale"])})
    assert torch.equal(clip.encode_image(dict(zeroed, **{key: w[key] * 1.2}), px, SMALL),
                       clip.encode_image(zeroed, px, SMALL))


@pytest.fixture(scope="module")
def deep():
    """RN50x64's depth, (3, 15, 36, 10) blocks, and input size, 448 px, at
    a width the CPU holds (the draw's scales do not depend on it)."""
    model = dict(SMALL, vision_width=8, vision_layers=[3, 15, 36, 10], image_size=448,
                 vision_heads=4, embed_dim=64)
    return model, data.make_weights(model, 5, "cpu"), _photos(model, 5)


def test_residual_stream_stays_in_range_through_rn50x64s_depth(deep):
    """Every branch adds at least a twentieth of its shortcut's RMS (the
    least, 0.088, in stage 3's 36 blocks), and the stream's RMS stays
    within 0.25-4x of the stem's output (it reads 1.3-1.7x)."""
    model, w, px = deep

    def rms(t):
        return float(t.pow(2).mean().sqrt())

    with torch.no_grad():
        h = resnet._stem(px.permute(0, 3, 1, 2), w, "fp32")
        stem = rms(h)
        for p, stride in resnet.blocks(model):
            out = resnet._bottleneck(h, w, p, stride, "fp32")
            cut = {p + ".bn3." + k: torch.zeros_like(w[p + ".bn3." + k])
                   for k in ("scale", "bias", "mean")}
            without = resnet._bottleneck(h, dict(w, **cut), p, stride, "fp32")
            assert rms(out - without) > 0.05 * rms(without), p
            h = out
            assert 0.25 < rms(h) / stem < 4.0, p


def test_photos_embed_apart_at_rn50x64s_depth(deep):
    """Different photos' embeddings lie apart by more than the check's
    gaps, so that a row of another photo reads as wrong: 1.9e-2 and more
    (with drawn statistics, 1 +- 0.05 and 0 +- 0.02, they lay 6e-6 - 3e-4
    apart)."""
    model, w, px = deep
    e = clip.encode_image(w, px, model).double()
    far = (1 - e @ e.T)[torch.triu_indices(len(e), len(e), 1).unbind()]
    assert float(far.min()) > 1e-3


def test_reference_runs_with_tf32_off(monkeypatch):
    seen = []
    conv2d = torch.nn.functional.conv2d

    def spy(*args, **kwargs):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return conv2d(*args, **kwargs)

    monkeypatch.setattr(resnet.F, "conv2d", spy)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    w = data.make_weights(SMALL, 6, "cpu")
    clip.encode_image(w, _photos(SMALL, 6, 1), SMALL)
    assert seen and set(seen) == {(False, False)}
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32


# -- a tiny ResNet configuration written only as files -----------------------


def _resnet_tree(tmp_path):
    """A benchmark tree holding the repo's index traffic kind and readers,
    plus a configuration of the resnet family and its cell, each a file."""
    for d in ("traffic", "metrics"):
        shutil.copytree(harness.ROOT / d, tmp_path / d)
    (tmp_path / "configs").mkdir()
    (tmp_path / "workloads").mkdir()
    config = json.loads((harness.ROOT / "configs" / "clip-vit-l14.json").read_text())
    model = dict(SMALL, name="small-rn", vision_width=8, vision_heads=4, text_width=32,
                 text_layers=2, embed_dim=64)
    config = dict(config, name="small-rn", model=model,
                  engine=dict(config["engine"], CLIP_MODEL="small-rn", INDEX_BATCH=16))
    (tmp_path / "configs" / "small-rn.json").write_text(json.dumps(config))
    (tmp_path / "workloads" / "index.small-rn.tiny.json").write_text(json.dumps({
        "name": "index.small-rn.tiny", "config": "small-rn", "traffic": "index_coco640",
        "chips": 1, "why": "a test", "units": {"index_card_images_per_s": "images/s"},
        "limits": {"cos_gap": BF16_GAP, "cos_gap_median": BF16_GAP}}))
    return tmp_path


def _index_run(root, tamper=None):
    workload, config, traffic = bench_run.load_cell("index.small-rn.tiny", root)
    traffic = dict(traffic, photos=32, max_passes=2, warm_photos=16, sample_per_pass=8,
                   writers=1)
    r = harness.Run(workload=workload, config=config, traffic=traffic, seed=2**33 + 5,
                    seconds=1.0, trace=False, device="cpu", tmp=root / "run",
                    started=time.monotonic(), tamper=tamper)
    r.tmp.mkdir()
    kind = bench_run.traffic_kind(traffic, root)
    result = kind.run(r)
    ok, _ = bench_run.judge(result["compared"], workload["limits"], result["problems"])
    return ok, result


def _flip_first_row(engine):
    inner = engine.encode_prepared_planar

    def broken(*prepared, fetch=True):
        emb = -np.array(inner(*prepared, fetch=True))
        return emb if fetch else type("Ready", (), {"resolve": lambda self: emb})()

    engine.encode_prepared_planar = broken


def test_resnet_config_from_files_runs_and_is_checked(tmp_path):
    root = _resnet_tree(tmp_path)
    ok, result = _index_run(root)
    assert result["failed"] == 0 and ok is True, result["compared"]
    assert result["compared"]["cos_gap"] < BF16_GAP, result["compared"]
    assert result["e2e"] == {"index_card_images_per_s": None}  # no card to trace
    ctx = result["ctx"]
    readers = bench_run.per_layer(dict(ctx, config={}), {"index_card_images_per_s", "setup_s"},
                                  root)
    assert readers["index_mfu"]["value"] == pytest.approx(
        100.0 * ctx["images"] * flops.resnet_fwd_flops(ctx["model"])
        / (ctx["elapsed_s"] * flops.PEAK_BF16_FLOPS))
    assert "device_idle.index" not in readers  # no trace on the CPU
    assert readers["host_images_per_s.index"]["value"] == ctx["images"] / ctx["elapsed_s"]


def test_resnet_config_check_fails_an_altered_answer(tmp_path):
    ok, result = _index_run(_resnet_tree(tmp_path), _flip_first_row)
    assert ok is False, result["compared"]


def test_image_route_at_full_scale_matches_the_programs_planar_route(tmp_path):
    """At 448 px a 640x480 photo decodes at full scale, where the program
    reads the file's own 4:2:0 chroma (the 224 px case is
    test_portbench_reference's)."""
    from evossearch_tpu_torch.preprocess import io as pio
    from evossearch_tpu_torch.preprocess.pipeline import (
        device_preprocess_planar_indexed, prepare_batch_planar)

    from portbench.reference import image

    if not pio.has_native_decode():
        pytest.skip("the program's native JPEG decoder is not built here")
    photo = dict(height=480, width=640, quality=85, amplitudes=[40, 24, 20, 40],
                 cells=[4, 16, 80, 320], noise=12)
    paths, _ = data.write_photos(tmp_path, 3, 9, photo, 1, "cpu")
    assert image.dct_scale(480, 640, 448) == 8
    parts = prepare_batch_planar(pio.load_batch_planar(paths, 448, True), 448)
    got = device_preprocess_planar_indexed(*(torch.as_tensor(a) for a in parts)).numpy()
    want = np.stack([image.preprocess(p, 448) for p in paths])
    # the same rounding-step allowance as at 224 px
    diff = np.abs(got - want)
    assert diff.max() <= 0.046 and (diff > 1e-4).mean() < 0.01
