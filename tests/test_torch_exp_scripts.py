"""The port's four experiment scripts (``evossearch_tpu_torch/scripts/
exp_merge_variants.py``, ``exp_merge_profile.py``, ``exp_rn50_profile.py``,
``exp_index_producer.py``) on the CPU, at small sizes.

The merge's stages against the port's production ``packed_topk`` (bit
for bit) and against the JAX package's ``_pallas_topk_packed`` in
interpret mode (on every row both certify) on the tree tests' exact-dot
inputs; the profile's trace tables; RN50's per-segment FLOPs against the
JAX script's formulas and both benches' totals, and the composed
segments against the full forward; the producer at 24 images; the three
card scripts without a CUDA device.
"""

from __future__ import annotations

import importlib.util
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evossearch_tpu.core import CLIP_MODEL_SPECS as JAX_SPECS
from evossearch_tpu.index.search import _pallas_topk_packed
from evossearch_tpu_torch import bench
from evossearch_tpu_torch.core import CLIP_MODEL_SPECS
from evossearch_tpu_torch.core.constants import CLIPResNetSpec
from evossearch_tpu_torch.index import search
from evossearch_tpu_torch.models import init_params
from evossearch_tpu_torch.ops import topk
from evossearch_tpu_torch.scripts import (
    exp_index_producer,
    exp_merge_profile,
    exp_merge_variants,
    exp_rn50_profile,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import bench as root_bench  # noqa: E402  (the JAX package's bench.py)

# the tree tests' sizes (tests/test_torch_topk.py): a ragged 5000 rows
N, D, Q, K = 5000, 128, 5, 4
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
TINY_RN = CLIPResNetSpec(
    name="exp-tiny-rn", image_size=64, vision_width=16,
    vision_layers=(1, 2, 1, 1), vision_heads=8, text_width=64, text_layers=1,
    text_heads=4, vocab_size=49408, context_length=16, embed_dim=D,
)


def _exact_inputs(seed=22, span=64):
    """Small integers over 16: exact dots in any order, real ties."""
    rng = np.random.default_rng(seed)
    emb = (rng.integers(-span, span + 1, (N, D)) / 16).astype(np.float32)
    queries = (rng.integers(-span, span + 1, (Q, D)) / 16).astype(np.float32)
    return emb, queries


def _jax_script(name: str):
    path = ROOT / "scripts" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"jax_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- exp_merge_variants ----------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_merge_s5_is_packed_topk_bit_for_bit(dtype):
    emb, queries = _exact_inputs()
    e = torch.from_numpy(emb).to(DTYPES[dtype][0])
    q = torch.from_numpy(queries)
    s5 = exp_merge_variants.stage(e, q, K, 5).numpy()
    prod = search.packed_topk(e, q, K, "tree").numpy()
    assert s5.shape == (Q, 2 * K + 1)
    assert s5.tobytes() == prod.tobytes()
    # the earlier stages run the same program and end in a device sum
    for upto in range(5):
        assert torch.isfinite(exp_merge_variants.stage(e, q, K, upto)).all()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_merge_s5_equals_jax_packed_where_both_certify(dtype):
    tdt, jdt = DTYPES[dtype]
    emb, queries = _exact_inputs()
    ref = np.asarray(_pallas_topk_packed(jnp.asarray(emb, jdt), jnp.asarray(queries), K,
                                         True, True))
    got = exp_merge_variants.stage(torch.from_numpy(emb).to(tdt), torch.from_numpy(queries),
                                   K, 5).numpy()
    both = (got[:, -1] > 0) & (ref[:, -1] > 0)
    assert both.any()
    np.testing.assert_array_equal(got[both, :K], ref[both, :K])
    np.testing.assert_array_equal(got[both, K:2 * K], ref[both, K:2 * K])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_merge_alternates_equal_production_where_both_certify(dtype):
    emb, queries = _exact_inputs()
    e = torch.from_numpy(emb).to(DTYPES[dtype][0])
    q = torch.from_numpy(queries)
    prod = search.packed_topk(e, q, K, "tree").numpy()
    a2 = exp_merge_variants.stage(e, q, K, 5, select=topk.stable_topk).numpy()
    assert exp_merge_variants.agree_where_certified(a2, prod, K)
    assert ((a2[:, -1] > 0) & (prod[:, -1] > 0)).any()
    row = exp_merge_variants.measure(e, q, K, reps=1, tiles=(512, 1024))
    assert row["ok"] and row["s5_equals_production"]
    assert list(row["stages_ms"]) == list(exp_merge_variants.STAGES)
    assert set(row["alternates"]) == {"a2", "a3/t512", "a3/t1024"}
    for alt in row["alternates"].values():
        assert alt["match"] and 0 <= alt["cert_rate"] <= 1
    assert row["launches"] == {}  # plain versions count no launch


def test_agree_where_certified_sees_a_difference():
    ref = np.array([[1.0, 0.5, 3.0, 7.0, 1.0], [1.0, 0.5, 3.0, 7.0, 0.0]], np.float32)
    out = ref.copy()
    out[1, 2] = 4.0  # uncertified in ref: not compared
    assert exp_merge_variants.agree_where_certified(out, ref, 2)
    out[0, 3] = 8.0
    assert not exp_merge_variants.agree_where_certified(out, ref, 2)


# -- exp_merge_profile -----------------------------------------------------


def test_merge_profile_table_on_cpu(tmp_path):
    emb, queries = _exact_inputs()
    row = exp_merge_profile.profile(torch.from_numpy(emb).to(torch.bfloat16),
                                    torch.from_numpy(queries), K, reps=2,
                                    trace_dir=str(tmp_path))
    assert pathlib.Path(row["trace"]).parent == tmp_path
    # no device events on the CPU: the host's ops, as the JAX script falls back
    assert row["ops_from"] == "host" and row["ops"]
    assert sum(row["ops"].values()) > 0 and all(us >= 0 for us in row["ops"].values())
    assert row["tracks"]["host"] and not row["tracks"]["device"]
    assert row["device_us"] == 0 and row["idle_share"] == 1.0
    assert not exp_merge_profile.names_tree_kernel(row["ops"])


def test_trace_table_device_side():
    b1 = "void evs::tc::tc_kernel<unsigned short, evs::tc::RawDot, 32, 64>(evs::tc::Args, int)"
    events = [
        {"ph": "M", "name": "process_name", "pid": 0, "tid": 0, "args": {"name": "GPU 0"}},
        {"ph": "M", "name": "thread_name", "pid": 0, "tid": 7, "args": {"name": "stream 7"}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::topk", "pid": 9, "tid": 9, "ts": 0, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": b1, "pid": 0, "tid": 7, "ts": 10, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "topk", "pid": 0, "tid": 7, "ts": 20, "dur": 20},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "pid": 0, "tid": 7, "ts": 50,
         "dur": 10},
    ]
    table = exp_merge_profile.trace_table(events, reps=2)
    assert table["ops_from"] == "device"
    assert table["ops"] == {b1: 10.0, "topk": 10.0, "Memcpy DtoH": 5.0}
    assert table["tracks"] == {"device": {"GPU 0/stream 7": 25.0}, "host": {"9/9": 50.0}}
    assert table["device_us"] == 25.0 and table["window_us"] == 50.0
    assert table["idle_share"] == pytest.approx(0.6)  # busy 10-40 and 50-60 of 0-100
    assert exp_merge_profile.names_tree_kernel(table["ops"])


# -- exp_rn50_profile ------------------------------------------------------


@pytest.mark.parametrize("name", ["RN50", "RN101", "RN50x4"])
def test_rn50_segment_flops_equal_jax_script(name):
    ref = _jax_script("exp_rn50_profile")
    spec, jspec = CLIP_MODEL_SPECS[name], JAX_SPECS[name]
    w, s = spec.vision_width, spec.image_size
    assert exp_rn50_profile.stem_flops(s // 2, w) == ref.stem_flops(s // 2, w)
    s, c = s // 4, w
    for i, n in enumerate(spec.vision_layers):
        got = exp_rn50_profile.stage_flops(i, s, c, w, n)
        assert got == ref.stage_flops(i, s, c, w, n)
        _, s, c = got
    assert exp_rn50_profile.attnpool_flops(spec) == ref.attnpool_flops(jspec)
    segs = exp_rn50_profile.segment_flops(spec)
    assert [n for n, _ in segs] == ["stem", "stage1", "stage2", "stage3", "stage4", "attnpool"]
    total = sum(f for _, f in segs)
    for bench_total in (bench._resnet_fwd_flops(spec), root_bench._resnet_fwd_flops(jspec)):
        assert abs(total - bench_total) / bench_total < 1e-6


def test_rn50_segments_compose_to_the_full_forward(monkeypatch):
    monkeypatch.setitem(CLIP_MODEL_SPECS, TINY_RN.name, TINY_RN)
    net = init_params(TINY_RN, seed=3, device="cpu").eval()
    images = torch.randn(3, TINY_RN.image_size, TINY_RN.image_size, 3,
                         generator=torch.Generator().manual_seed(4))
    outs = exp_rn50_profile.composed(net.visual, images, torch.float32)
    with torch.no_grad():
        full = net.visual(images, torch.float32)
    assert len(outs) == 6 and outs[-1].dtype == torch.float32
    assert torch.equal(outs[-1], full)
    rows = exp_rn50_profile.measure("cpu", model=TINY_RN.name, batch=2, reps=1, sweep=(3,))
    assert [r["measure"] for r in rows] == ["rn50_full", "rn50_segments", "rn50_batch"]
    assert all(r["ok"] for r in rows)
    assert rows[0]["gflop_per_image"] == pytest.approx(rows[0]["bench_gflop_per_image"])
    seg = rows[1]["segments"]
    assert [s["name"] for s in seg] == ["stem", "stage1", "stage2", "stage3", "stage4", "attnpool"]
    assert sum(s["share"] for s in seg) == pytest.approx(1.0)


# -- exp_index_producer ----------------------------------------------------


def test_index_producer_at_24_images():
    rows, table = exp_index_producer.measure(n=24, runs=1, top=5)
    decode, build = rows
    assert decode["measure"] == "decode_only" and build["measure"] == "stub_build"
    assert decode["counted"] == [24] and build["counted"] == [24]
    for row in rows:
        assert sum(row["routes"].values()) == 24
        assert row["ok"] and row["clock"] == "host" and row["host"]["cpus"] >= 1
    assert build["native_route"] in ("system", "pillow", "none")
    assert "_pipelined_build" in table


# -- no CUDA ---------------------------------------------------------------


def test_card_scripts_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for script in (exp_merge_variants, exp_merge_profile, exp_rn50_profile):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            script.main()
