"""The public helpers of the JAX package the port also exports, each
against its JAX counterpart on the CPU: ``index.search.exact_search`` and
``dispatch_counts_snapshot``, ``models.count_params`` and
``init_params``, ``models.resnet.encode_image_resnet``,
``preprocess.preprocess_batch``, ``preprocess_reference`` and
``chroma_resample_matrix``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from evossearch_tpu.core.constants import CLIPModelSpec as RefSpec
from evossearch_tpu.index import search as ref_search
from evossearch_tpu.models import count_params as ref_count_params
from evossearch_tpu.models import expected_param_count as ref_expected_param_count
from evossearch_tpu.models import init_params as ref_init_params
from evossearch_tpu.models.resnet import encode_image_resnet as ref_encode_image_resnet
from evossearch_tpu.preprocess import chroma_resample_matrix as ref_chroma_resample_matrix
from evossearch_tpu.preprocess import preprocess_batch as ref_preprocess_batch
from evossearch_tpu.preprocess import preprocess_reference as ref_preprocess_reference
from evossearch_tpu_torch.core import CLIP_MODEL_SPECS, CLIPModelSpec
from evossearch_tpu_torch.index import exact_search
from evossearch_tpu_torch.index import search
from evossearch_tpu_torch.models import count_params, init_params, params_from_numpy
from evossearch_tpu_torch.models.checkpoint import _flatten, params_to_numpy
from evossearch_tpu_torch.models.resnet import encode_image_resnet
from evossearch_tpu_torch.preprocess import (
    chroma_resample_matrix,
    preprocess_batch,
    preprocess_reference,
)
from test_torch_preprocess import _uint8_domain
from test_torch_resnet import ATOL, RTOL, TINY_RN, _images, _params, _ref_spec

TINY = CLIPModelSpec(
    name="tiny", image_size=32, patch_size=16, vision_width=64,
    vision_layers=2, vision_heads=4, text_width=64, text_layers=2,
    text_heads=4, vocab_size=256, context_length=16, embed_dim=32,
)
REF_TINY = RefSpec(**dataclasses.asdict(TINY))


def _unit_rows(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("n,k", [(1000, 48), (1 << 18, 48), (1 << 18, 5), (3, 48)])
def test_exact_search_matches_jax(n, k):
    """Below 2^18 rows and from it (where the JAX package takes its
    certified route): the same ids, scores within 1e-6; k clamped to n."""
    rng = np.random.default_rng(n + k)
    emb = _unit_rows(rng, n, 64)
    for q in _unit_rows(rng, 3, 64):
        want_s, want_i = ref_search.exact_search(emb, q, k)
        got_s, got_i = exact_search(torch.from_numpy(emb), q, k)
        assert got_i.dtype == np.int64 and got_s.shape == (min(k, n),)
        np.testing.assert_array_equal(got_i, np.asarray(want_i))
        np.testing.assert_allclose(got_s, np.asarray(want_s), atol=1e-6, rtol=0)
    # a float32 numpy corpus is taken as it is, to the CPU
    np.testing.assert_array_equal(exact_search(emb, q, k)[1], got_i)


def test_exact_search_ties_and_empty():
    emb = np.tile(np.eye(4, dtype=np.float32)[0], (32, 1))
    q = np.eye(4, dtype=np.float32)[0]
    np.testing.assert_array_equal(exact_search(torch.from_numpy(emb), q, 10)[1], np.arange(10))
    s, i = exact_search(torch.zeros((0, 8)), np.zeros(8, np.float32), 5)
    assert s.shape == i.shape == (0,)


def test_dispatch_counts_snapshot_is_a_copy_with_the_jax_keys():
    snap = search.dispatch_counts_snapshot()
    assert snap == search.DISPATCH_COUNTS and snap is not search.DISPATCH_COUNTS
    assert set(snap) == set(ref_search.dispatch_counts_snapshot())
    search.DISPATCH_COUNTS["kernel"] += 1
    try:
        assert search.dispatch_counts_snapshot()["kernel"] == snap["kernel"] + 1
    finally:
        search.DISPATCH_COUNTS["kernel"] -= 1


@pytest.mark.parametrize("spec", [TINY, TINY_RN], ids=lambda s: s.name)
def test_count_params_matches_jax(spec):
    params = (jax.device_get(ref_init_params(jax.random.key(0), RefSpec(**dataclasses.asdict(spec))))
              if spec is TINY else _params(spec))
    assert count_params(params_from_numpy(params, spec, "cpu")) == ref_count_params(params)


@pytest.mark.parametrize("name", ["ViT-B/32", "RN50"])
def test_init_params_shapes_and_count(name):
    spec = CLIP_MODEL_SPECS[name] if name == "RN50" else TINY
    model = init_params(spec, seed=3, device="cpu")
    assert next(model.parameters()).device.type == "cpu"
    assert count_params(model) == ref_expected_param_count(_ref_spec(spec)
                                                          if name == "RN50" else REF_TINY)
    if name != "RN50":
        got = _flatten(params_to_numpy(model))
        want = _flatten(jax.device_get(ref_init_params(jax.random.key(3), REF_TINY)))
        assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
        again = _flatten(params_to_numpy(init_params(spec, seed=3, device="cpu")))
        assert all(np.array_equal(got[k], again[k]) for k in got)
        other = _flatten(params_to_numpy(init_params(spec, seed=4, device="cpu")))
        assert not np.array_equal(got["visual/proj"], other["visual/proj"])


def test_encode_image_resnet_matches_jax():
    params = _params(TINY_RN)
    model = params_from_numpy(params, TINY_RN, "cpu")
    images = _images(TINY_RN)
    want = np.asarray(ref_encode_image_resnet(params, jnp.asarray(images), _ref_spec(TINY_RN)))
    got = encode_image_resnet(model, torch.from_numpy(images)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    raw = encode_image_resnet(model, torch.from_numpy(images), normalize=False).numpy()
    want_raw = np.asarray(ref_encode_image_resnet(params, jnp.asarray(images),
                                                  _ref_spec(TINY_RN), normalize=False))
    np.testing.assert_allclose(raw, want_raw, rtol=RTOL, atol=ATOL * np.abs(want_raw).max())
    with pytest.raises(ValueError, match="no ResNet"):
        encode_image_resnet(init_params(TINY, device="cpu"), torch.from_numpy(images))


def _mixed_images(rng):
    """PIL images of mixed sizes and modes (one past max_side, one
    greyscale) and one uint8 array."""
    sizes = [(480, 640), (224, 224), (120, 90), (1200, 1600)]
    out = [Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8), "RGB")
           for h, w in sizes]
    out.append(Image.fromarray(rng.integers(0, 256, (300, 200), dtype=np.uint8), "L"))
    out.append(rng.integers(0, 256, (333, 500, 3), dtype=np.uint8))
    return out


@pytest.mark.parametrize("target,max_side", [(224, 1024), (336, 704)])
def test_preprocess_batch_matches_jax(target, max_side):
    """Within 1e-5, but where the two packages' float32 summation orders
    land on opposite sides of a round-half case in the resample (its
    uint8 rounding between the passes, and the host pre-shrink): there
    the value is one 8-bit step off, on at most 0.1% of the values
    (``tests/test_torch_preprocess.py``'s rule for the same stages)."""
    images = _mixed_images(np.random.default_rng(target))
    want = np.asarray(ref_preprocess_batch(images, target=target, max_side=max_side))
    got = preprocess_batch(images, target=target, max_side=max_side, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (len(images), target, target, 3)
    got = got.numpy()
    off = np.abs(got - want) > 1e-5
    assert off.mean() <= 1e-3
    steps = np.abs(_uint8_domain(got) - _uint8_domain(want))
    assert (steps[off] == 1).all()
    bf16 = preprocess_batch(images, target=target, max_side=max_side,
                            out_dtype=torch.bfloat16, device="cpu")
    assert bf16.dtype == torch.bfloat16
    np.testing.assert_allclose(bf16.float().numpy(), got, atol=0.04)


@pytest.mark.parametrize("size,target", [((480, 640), 224), ((120, 90), 224),
                                         ((500, 500), 336)])
def test_preprocess_reference_is_bit_equal(size, target):
    rng = np.random.default_rng(size[0])
    img = Image.fromarray(rng.integers(0, 256, (*size, 3), dtype=np.uint8), "RGB")
    got = preprocess_reference(img, target=target)
    assert got.dtype == np.float32 and got.shape == (target, target, 3)
    np.testing.assert_array_equal(got, ref_preprocess_reference(img, target=target))
    grey = img.convert("L")
    np.testing.assert_array_equal(preprocess_reference(grey, target),
                                  ref_preprocess_reference(grey, target))


@pytest.mark.parametrize("args", [(640, 320, 224), (480, 240, 224, 37.0, 224),
                                  (225, 113, 224), (1600, 800, 336, 61.5, 336)])
def test_chroma_resample_matrix_is_the_jax_one(args):
    np.testing.assert_array_equal(chroma_resample_matrix(*args), ref_chroma_resample_matrix(*args))
