"""The port's CLIP towers against the JAX package's, through the npz
checkpoint written by the JAX package (f32, atol 2e-5: summation order
differs between XLA and PyTorch on the CPU, by ~1e-7 measured)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evossearch_tpu.core import CLIP_MODEL_SPECS
from evossearch_tpu.models import encode_image as ref_encode_image
from evossearch_tpu.models import encode_text as ref_encode_text
from evossearch_tpu.models import init_params
from evossearch_tpu.models.checkpoint import save_params
from evossearch_tpu_torch.models import (
    CLIP,
    encode_image,
    encode_text,
    load_model,
    params_from_numpy,
)

ATOL = 2e-5
VIT_B32 = CLIP_MODEL_SPECS["ViT-B/32"]
TINY = dataclasses.replace(
    VIT_B32, name="tiny", image_size=64, patch_size=16, vision_width=64,
    vision_layers=2, vision_heads=4, text_width=48, text_layers=2,
    text_heads=4, embed_dim=32,
)


def _inputs(spec, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal(
        (2, spec.image_size, spec.image_size, 3)).astype(np.float32)
    tokens = np.zeros((2, spec.context_length), np.int32)
    tokens[:, 0] = 49406
    tokens[0, 1:6] = [320, 1125, 539, 320, 49407]
    tokens[1, 1:4] = [2368, 7651, 49407]
    return images, tokens


@pytest.mark.parametrize("spec", [TINY, VIT_B32], ids=["tiny", "ViT-B-32"])
def test_embeddings_match_through_npz(spec, tmp_path):
    params = init_params(jax.random.key(3), spec)
    path = save_params(tmp_path / "ckpt.npz", params, spec)
    model, loaded_spec = load_model(path, device="cpu")
    assert dataclasses.asdict(loaded_spec) == dataclasses.asdict(spec)
    images, tokens = _inputs(spec)
    want_img = np.asarray(ref_encode_image(params, jnp.asarray(images), spec))
    want_txt = np.asarray(ref_encode_text(params, jnp.asarray(tokens), spec))
    got_img = encode_image(model, torch.from_numpy(images)).numpy()
    got_txt = encode_text(model, torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got_img, want_img, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got_txt, want_txt, rtol=0, atol=ATOL)

    # the bridge over the in-memory tree gives the same module
    tree = jax.tree_util.tree_map(np.asarray, params)
    bridged = params_from_numpy(tree, spec, device="cpu")
    for (name, a), (name_b, b) in zip(
        model.state_dict().items(), bridged.state_dict().items()
    ):
        assert name == name_b
        assert torch.equal(a, b), name


def test_bf16_compute_close_to_reference():
    """bf16 compute: both packages round at the same places, but XLA may
    fuse elementwise ops in f32 where PyTorch rounds each; the stated bar
    is the embeddings' cosine."""
    params = init_params(jax.random.key(4), TINY)
    model = params_from_numpy(jax.tree_util.tree_map(np.asarray, params), TINY,
                              device="cpu")
    images, tokens = _inputs(TINY, seed=1)
    want = np.asarray(ref_encode_image(
        params, jnp.asarray(images), TINY, compute_dtype=jnp.bfloat16))
    got = encode_image(model, torch.from_numpy(images), torch.bfloat16).numpy()
    assert np.all((want * got).sum(axis=1) > 0.999)
    want = np.asarray(ref_encode_text(
        params, jnp.asarray(tokens), TINY, compute_dtype=jnp.bfloat16))
    got = encode_text(model, torch.from_numpy(tokens), torch.bfloat16).numpy()
    assert np.all((want * got).sum(axis=1) > 0.999)


def test_bridge_rejects_missing_leaves():
    params = jax.tree_util.tree_map(np.asarray, init_params(jax.random.key(0), TINY))
    del params["visual"]["proj"]
    with pytest.raises(RuntimeError):
        params_from_numpy(params, TINY, device="cpu")


def test_default_device_is_the_gpu_or_a_raise(tmp_path):
    """With no device, both entry points take the GPU; without one they
    raise rather than fall back to the CPU (decided here, in the body)."""
    params = jax.tree_util.tree_map(np.asarray, init_params(jax.random.key(5), TINY))
    path = save_params(tmp_path / "ckpt.npz", params, TINY)
    calls = (lambda: params_from_numpy(params, TINY), lambda: load_model(path)[0])
    for call in calls:
        if torch.cuda.is_available():
            assert next(call().parameters()).device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()


def test_random_init_is_seeded():
    a = CLIP(TINY).init_random_(torch.Generator().manual_seed(0))
    b = CLIP(TINY).init_random_(torch.Generator().manual_seed(0))
    for (_, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(x, y)
    images, _ = _inputs(TINY)
    emb = encode_image(a, torch.from_numpy(images))
    assert emb.shape == (2, TINY.embed_dim)
    np.testing.assert_allclose(emb.norm(dim=1).numpy(), 1.0, atol=1e-6)
