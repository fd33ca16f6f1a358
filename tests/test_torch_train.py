"""The port's contrastive training step against the JAX package's
(``tests/test_train.py``'s tiny spec and inputs, made from a seed with
numpy): the loss and every gradient leaf in float32, the weight-decay
mask leaf for leaf, the clipped AdamW alone fed the JAX gradients, a few
full steps, remat, the bf16 product's backward, the ResNet refusal, and
the param pytree's round trip through ``params_from_numpy``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from evossearch_tpu.core.constants import CLIPModelSpec as RefSpec
from evossearch_tpu.core.constants import CLIPResNetSpec as RefResNetSpec
from evossearch_tpu.models import init_params
from evossearch_tpu.train import clip_loss as ref_clip_loss
from evossearch_tpu.train import make_optimizer as ref_make_optimizer
from evossearch_tpu.train import make_train_step as ref_make_train_step
from evossearch_tpu.train.contrastive import decay_mask as ref_decay_mask
from evossearch_tpu_torch.core import CLIP_MODEL_SPECS, CLIPModelSpec, CLIPResNetSpec
from evossearch_tpu_torch.models import CLIP, params_from_numpy, params_to_numpy
from evossearch_tpu_torch.models.checkpoint import named_from_tree, tree_from_named, tree_leaves
from evossearch_tpu_torch.models.layers import MatmulF32
from evossearch_tpu_torch.train import (
    clip_loss,
    decay_mask,
    make_optimizer,
    make_train_step,
)

# float32 on one CPU, two implementations of the same graph: only the
# summation order of the products differs, so a gradient element is held
# to RTOL of itself plus LEAF_ATOL of its leaf's largest magnitude (the
# worst seen is 2e-6 of it: elements near zero carry their leaf's
# rounding)
RTOL, LEAF_ATOL = 1e-4, 1e-5
LOSS_RTOL = 1e-4  # a few full steps: the same rounding, compounded
TINY = CLIPModelSpec(
    name="tiny", image_size=32, patch_size=16, vision_width=64,
    vision_layers=2, vision_heads=4, text_width=64, text_layers=2,
    text_heads=4, vocab_size=256, context_length=16, embed_dim=32,
)
REF_TINY = RefSpec(**dataclasses.asdict(TINY))
# tests/test_resnet.py's tiny spec: multi-block and single-block stages
TINY_RN = CLIPResNetSpec(
    name="tiny-rn", image_size=64,
    vision_width=16, vision_layers=(2, 1, 1, 2), vision_heads=8,
    text_width=48, text_layers=2, text_heads=4,
    vocab_size=512, context_length=16, embed_dim=32,
)


def _batch(n=8):
    rng = np.random.default_rng(0)
    images = rng.standard_normal((n, 32, 32, 3)).astype(np.float32)
    tokens = np.zeros((n, 16), np.int32)
    tokens[:, 0] = 1
    tokens[:, 1:8] = rng.integers(2, 254, (n, 7))
    tokens[:, 8] = 255  # eot = max id
    return images, tokens


@pytest.fixture(scope="module")
def params():
    return jax.device_get(init_params(jax.random.key(0), REF_TINY))


# jitted: the eager trace of the towers' backward takes seconds per call
_ref_value_and_grad = jax.jit(jax.value_and_grad(ref_clip_loss), static_argnums=(3, 4, 5))


def _grad_tree(model) -> dict:
    return tree_from_named({n: p.grad.numpy() for n, p in model.named_parameters()})


def _port_loss_and_grads(params, images, tokens, remat=True, dtype=torch.float32):
    model = params_from_numpy(params, TINY, "cpu")
    loss = clip_loss(model, torch.from_numpy(images), torch.from_numpy(tokens),
                     compute_dtype=dtype, remat=remat)
    loss.backward()
    return float(loss.detach()), _grad_tree(model)


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_every_gradient_leaf_match_jax(params, remat):
    images, tokens = _batch()
    want, want_g = _ref_value_and_grad(
        params, jnp.asarray(images), jnp.asarray(tokens), REF_TINY, jnp.float32, remat)
    got, got_g = _port_loss_and_grads(params, images, tokens, remat)
    np.testing.assert_allclose(got, float(want), rtol=RTOL)
    assert jax.tree_util.tree_structure(want_g) == jax.tree_util.tree_structure(got_g)
    for w, g in zip(jax.tree_util.tree_leaves(want_g), tree_leaves(got_g)):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=LEAF_ATOL * np.abs(w).max())


def test_bf16_gradients_agree_with_jax_by_cosine(params):
    """bf16 rounds at other places in the two frameworks: per leaf, the
    gradients agree by cosine (the smoke's bf16 rule on the card)."""
    images, tokens = _batch()
    _, want_g = _ref_value_and_grad(
        params, jnp.asarray(images), jnp.asarray(tokens), REF_TINY, jnp.bfloat16, True)
    _, got_g = _port_loss_and_grads(params, images, tokens, dtype=torch.bfloat16)
    for w, g in zip(jax.tree_util.tree_leaves(want_g), tree_leaves(got_g)):
        w = np.asarray(w, np.float64).ravel()
        g = g.astype(np.float64).ravel()
        assert g @ w / (np.linalg.norm(g) * np.linalg.norm(w)) >= 0.99


def test_remat_leaves_loss_and_gradients_unchanged(params):
    images, tokens = _batch()
    a, ga = _port_loss_and_grads(params, images, tokens, remat=True)
    b, gb = _port_loss_and_grads(params, images, tokens, remat=False)
    assert a == b
    for x, y in zip(tree_leaves(ga), tree_leaves(gb)):
        np.testing.assert_allclose(x, y, rtol=1e-6, atol=0)


def test_decay_mask_matches_jax_leaf_for_leaf(params):
    model = params_from_numpy(params, TINY, "cpu")
    mask = decay_mask(model)
    want = ref_decay_mask(params)
    got = tree_from_named({n: np.full(p.shape, mask[n]) for n, p in model.named_parameters()})
    for w, g in zip(jax.tree_util.tree_leaves(want), tree_leaves(got)):
        assert g.all() == w and (~g).all() == (not w)
    assert not mask["logit_scale"] and mask["visual.blocks.0.attn.wqkv"]
    assert not mask["text.blocks.1.mlp.b2"] and not mask["visual.class_embedding"]


@pytest.mark.parametrize("scale", [0.01, 1.0], ids=["below_clip", "clipped"])
def test_clipped_adamw_matches_optax_on_the_jax_gradients(params, scale):
    """The JAX gradients of three successive JAX steps, fed to both
    optimizers: params within lr * 1e-5 plus 2 ulp of the param (the
    bias corrections' powers and the global norm's summation order), the
    state leaves one to one. The loss is scaled so that the gradients'
    global norm stays below the clip or goes above it at every step."""
    images, tokens = _batch()
    lr = 1e-3
    opt = ref_make_optimizer(learning_rate=lr)
    state = opt.init(params)
    grad_fn = jax.jit(jax.grad(
        lambda p: scale * ref_clip_loss(p, jnp.asarray(images), jnp.asarray(tokens), REF_TINY)))
    model = params_from_numpy(params, TINY, "cpu")
    port_opt = make_optimizer(learning_rate=lr)
    port_state = port_opt.init(model)
    p = params
    norms = []
    for _ in range(3):
        g = grad_fn(p)
        norms.append(float(jnp.sqrt(sum(jnp.sum(x * x) for x in jax.tree_util.tree_leaves(g)))))
        updates, state = opt.update(g, state, p)
        p = jax.tree_util.tree_map(lambda a, b: a + b, p, updates)
        named = named_from_tree(jax.device_get(g))
        for n, param in model.named_parameters():
            param.grad = torch.from_numpy(np.array(named[n]))
        port_opt.update(model, port_state)
    assert all((n > 1.0) == (scale == 1.0) for n in norms)
    for w, g in zip(jax.tree_util.tree_leaves(jax.device_get(p)),
                    tree_leaves(params_to_numpy(model))):
        w = np.asarray(w)
        assert np.all(np.abs(g - w) <= lr * 1e-5 + 2 * np.spacing(np.abs(w)))
    adam = state[1][0]
    assert int(adam.count) == port_state.count == 3
    for ref_m, port_m in ((adam.mu, port_state.mu), (adam.nu, port_state.nu)):
        port_tree = tree_from_named({n: t.numpy() for n, t in port_m.items()})
        for w, g in zip(jax.tree_util.tree_leaves(ref_m), tree_leaves(port_tree)):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-9)


def test_a_few_full_steps_match_jax(params):
    images, tokens = _batch()
    opt = ref_make_optimizer(learning_rate=1e-3)
    step = jax.jit(ref_make_train_step(REF_TINY, opt))
    p, state = params, opt.init(params)
    port_opt = make_optimizer(learning_rate=1e-3)
    model = params_from_numpy(params, TINY, "cpu")
    port_state = port_opt.init(model)
    port_step = make_train_step(TINY, port_opt)
    want, got = [], []
    for _ in range(4):
        p, state, loss = step(p, state, jnp.asarray(images), jnp.asarray(tokens))
        want.append(float(loss))
        got.append(float(port_step(model, port_state, torch.from_numpy(images),
                                   torch.from_numpy(tokens))))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert got[-1] < got[0]


def test_loss_finite_and_decreases():
    model = CLIP(TINY).init_random_(torch.Generator().manual_seed(0))
    images, tokens = (torch.from_numpy(a) for a in _batch())
    opt = make_optimizer(learning_rate=1e-3)
    step = make_train_step(TINY, opt)
    state = opt.init(model)
    with torch.no_grad():
        loss0 = float(clip_loss(model, images, tokens))
    assert np.isfinite(loss0)
    for _ in range(5):
        loss = step(model, state, images, tokens)
    assert float(loss) < loss0  # overfits one batch fast


def test_resnet_training_is_refused():
    spec = CLIP_MODEL_SPECS["RN50"]
    with pytest.raises(NotImplementedError, match="ViT family only"):
        make_train_step(spec, make_optimizer())
    with pytest.raises(NotImplementedError, match="ViT family only"):
        ref_make_train_step(RefResNetSpec(**dataclasses.asdict(spec)), ref_make_optimizer())


@pytest.mark.parametrize("shape_b", [(24, 40), (2, 3, 24, 40)])
def test_matmul_f32_backward_is_the_widened_products(shape_b):
    """``MatmulF32`` (the card's bf16 route) on CPU tensors: its gradients
    equal autograd's through the CPU route, bit for bit: the float32
    cotangent times the widened other operand, cast to bf16."""
    rng = np.random.default_rng(3)
    a0 = torch.from_numpy(rng.standard_normal((2, 3, 5, 24)).astype(np.float32))
    b0 = torch.from_numpy(rng.standard_normal(shape_b).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((2, 3, 5, 40)).astype(np.float32))
    grads = []
    for fn in (lambda a, b: torch.matmul(a.float(), b.float()), MatmulF32.apply):
        a = a0.to(torch.bfloat16).requires_grad_()
        b = b0.to(torch.bfloat16).requires_grad_()
        out = fn(a, b)
        assert out.dtype == torch.float32
        out.backward(g)
        grads.append((out.detach(), a.grad, b.grad))
    for want, got in zip(*grads):
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("spec", [TINY, TINY_RN], ids=["vit", "resnet"])
def test_params_to_numpy_inverts_params_from_numpy(spec):
    """A port module's pytree has the JAX package's keys and shapes
    (blocks and ResNet stage tails restacked; the JAX init's shapes by
    ``jax.eval_shape``), and pytree -> module -> pytree is the identity."""
    ref_cls = RefResNetSpec if spec.family == "resnet" else RefSpec
    ref_spec = ref_cls(**dataclasses.asdict(spec))
    want = jax.eval_shape(lambda key: init_params(key, ref_spec), jax.random.key(1))
    tree = params_to_numpy(CLIP(spec).init_random_(torch.Generator().manual_seed(1)))
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(want)
    assert [t.shape for t in tree_leaves(tree)] == [w.shape for w in jax.tree_util.tree_leaves(want)]
    back = params_to_numpy(params_from_numpy(tree, spec, "cpu"))
    for w, g in zip(tree_leaves(tree), tree_leaves(back)):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)


def test_params_to_numpy_of_the_jax_init(params):
    back = params_to_numpy(params_from_numpy(params, TINY, "cpu"))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for w, g in zip(jax.tree_util.tree_leaves(params), tree_leaves(back)):
        np.testing.assert_array_equal(g, np.asarray(w, np.float32))
