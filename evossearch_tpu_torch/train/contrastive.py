"""Contrastive (CLIP-style) training — PyTorch counterpart of
``evossearch_tpu/train/contrastive.py``.

The loss is the symmetric InfoNCE over the batch, in float32, with the
towers run with autograd (``models.embed_image`` / ``embed_text``) and,
by default, each block recomputed in the backward pass (``remat``, the
JAX package's default too). The optimizer is optax's
``clip_by_global_norm(1.0)`` then AdamW with decay masked off gains,
biases and ``logit_scale``, written out here with optax's arithmetic in
optax's order, so its state is optax's ``ScaleByAdamState(count, mu, nu)``
one to one.

The same loss, optimizer and step take a ``ShardedCLIP`` on a (data,
model) mesh: ``DATA_AXIS``, ``MODEL_AXIS``, ``train_mesh``,
``clip_param_specs``, ``clip_param_shardings`` and ``batch_shardings``
are defined in ``train/sharded.py`` with the tensor-parallel towers and
exported here, as the JAX module exports them. Its moments are sharded
like its params (``ShardedAdamState``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..core.constants import CLIPModelSpec
from ..models.checkpoint import _unflatten, tree_items
from ..models.clip import embed_image, embed_text
from ..parallel.mesh import ShardedTensor
from .sharded import (  # noqa: F401  (the JAX module's mesh names, exported here)
    DATA_AXIS,
    MODEL_AXIS,
    ShardedCLIP,
    batch_shardings,
    clip_param_shardings,
    clip_param_specs,
    reduce_gradients,
    sharded_embeddings,
    train_mesh,
)

# Param leaf names excluded from weight decay (CLIP/AdamW convention: no
# decay on gains or biases; logit_scale is a temperature, not a weight).
_NO_DECAY_NAMES = frozenset(
    {"scale", "bias", "bqkv", "bo", "b1", "b2", "class_embedding",
     "logit_scale"}
)


def clip_loss(model, images: torch.Tensor, tokens: torch.Tensor,
              compute_dtype: torch.dtype = torch.float32,
              remat: bool = True) -> torch.Tensor:
    """Symmetric InfoNCE over the (global) batch: a float32 scalar with
    autograd. ``model`` is a :class:`CLIP` or a ``ShardedCLIP``, whose
    loss is computed on its mesh's first device."""
    if isinstance(model, ShardedCLIP):
        img_emb, txt_emb = sharded_embeddings(model, images, tokens, compute_dtype, remat)
        logit_scale = model.params["logit_scale"].shards[0]
    else:
        img_emb = embed_image(model, images, compute_dtype, remat)
        txt_emb = embed_text(model, tokens, compute_dtype, remat)
        logit_scale = model.logit_scale
    # OpenAI clamps the learned temperature at 100.
    scale = torch.clamp(logit_scale.float().exp(), max=100.0)
    logits = scale * (img_emb @ txt_emb.T)
    labels = torch.arange(logits.shape[0], device=logits.device)
    return 0.5 * (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels))


def _decays(name: str) -> bool:
    """Whether AdamW weight decay applies to a parameter, by the last part
    of its module name or tree key (kernels and embeddings only)."""
    return name.replace("/", ".").rsplit(".", 1)[-1] not in _NO_DECAY_NAMES


def decay_mask(model) -> dict[str, bool]:
    """Parameter name -> whether AdamW weight decay applies, by the name's
    last part (kernels and embeddings only)."""
    return {name: _decays(name) for name, _ in model.named_parameters()}


@dataclasses.dataclass
class AdamState:
    """optax's ``ScaleByAdamState``: the step count and the first and
    second moments, by parameter name."""

    count: int
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]


@dataclasses.dataclass
class ShardedAdamState:
    """The Adam state of a ``ShardedCLIP``: the step count, and the moments
    by tree key, each sharded like its param."""

    count: int
    mu: dict[str, ShardedTensor]
    nu: dict[str, ShardedTensor]

    @classmethod
    def abstract(cls, model: ShardedCLIP) -> "ShardedAdamState":
        """Shapes and shardings without data (``model`` may be abstract
        too): a target to restore into."""
        def like():
            return {k: ShardedTensor(v.sharding, v.shape, v.dtype) for k, v in model.params.items()}
        return cls(0, like(), like())

    def tree(self) -> dict:
        return {"count": self.count, "mu": _unflatten(self.mu), "nu": _unflatten(self.nu)}

    def from_tree(self, tree: dict) -> "ShardedAdamState":
        return ShardedAdamState(int(tree["count"]), tree_items(tree["mu"]), tree_items(tree["nu"]))


@dataclasses.dataclass(frozen=True)
class ClippedAdamW:
    """optax.chain(clip_by_global_norm(grad_clip), adamw(learning_rate,
    b1, b2, eps, weight_decay, mask=decay_mask)), applied in place.

    Each step, in optax's order and float32: the global norm of the
    gradients; below ``grad_clip`` they stay as they are, above it each
    becomes ``g / norm * grad_clip``; ``mu = (1 - b1) g + b1 mu``, ``nu =
    (1 - b2) g^2 + b2 nu``; ``u = (mu / (1 - b1^t)) / (sqrt(nu / (1 -
    b2^t)) + eps)``, plus ``weight_decay * p`` where the mask holds; ``p +=
    -lr * u``. The bias corrections are float32, as optax computes them."""

    learning_rate: float = 1e-5
    weight_decay: float = 0.2
    b1: float = 0.9
    b2: float = 0.98
    eps: float = 1e-6
    grad_clip: float = 1.0

    def init(self, model) -> AdamState | ShardedAdamState:
        if isinstance(model, ShardedCLIP):
            return ShardedAdamState(0, {k: v.zeros_like() for k, v in model.params.items()},
                                    {k: v.zeros_like() for k, v in model.params.items()})
        zeros = {name: torch.zeros_like(p) for name, p in model.named_parameters()}
        return AdamState(0, zeros, {k: torch.zeros_like(v) for k, v in zeros.items()})

    @torch.no_grad()
    def update(self, model, state: AdamState | ShardedAdamState) -> None:
        """One step from the parameters' ``.grad``; updates ``model`` and
        ``state`` in place. The gradients are consumed: each ``.grad``
        is overwritten with the step's update. Beside the parameters,
        gradients and moments, the step holds one scratch copy of the
        gradients, not one per intermediate.

        On a ``ShardedCLIP`` the gradients are first summed over the
        positions holding each slice (``reduce_gradients``), the norm is
        the logical gradient's, and every position then takes the same
        step on its shards and its moments' shards (one position at a
        time), so replicated copies stay equal bit for bit."""
        if isinstance(model, ShardedCLIP):
            norm = reduce_gradients(model)
            state.count += 1
            keys = list(model.params)
            for pos in range(model.mesh.size):
                params = [model.params[k].shards[pos] for k in keys]
                self._apply(keys, params, [p.grad for p in params],
                            [state.mu[k].shards[pos] for k in keys],
                            [state.nu[k].shards[pos] for k in keys],
                            norm.to(params[0].device), state.count)
            return
        names, params, grads = [], [], []
        for name, p in model.named_parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            names.append(name)
            params.append(p)
            grads.append(p.grad)
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        state.count += 1
        self._apply(names, params, grads, [state.mu[n] for n in names],
                    [state.nu[n] for n in names], norm, state.count)

    @torch.no_grad()
    def _apply(self, names: list[str], params: list[torch.Tensor], grads: list[torch.Tensor],
               mu: list[torch.Tensor], nu: list[torch.Tensor], norm: torch.Tensor,
               count: int) -> None:
        """The clip by ``norm`` and the AdamW step at step ``count`` on
        tensors of one device, in place (``grads`` become the updates)."""
        keep = norm < self.grad_clip
        one = torch.ones((), device=norm.device)
        # g / norm * grad_clip above the norm; g itself below (x / 1 * 1 is exact)
        torch._foreach_div_(grads, torch.where(keep, one, norm))
        if self.grad_clip != 1.0:
            torch._foreach_mul_(grads, torch.where(keep, one, one * self.grad_clip))
        scratch = torch._foreach_mul(grads, 1 - self.b1)
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, scratch)  # (1 - b1) g + b1 mu
        torch._foreach_copy_(scratch, grads)
        torch._foreach_mul_(scratch, grads)
        torch._foreach_mul_(scratch, 1 - self.b2)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, scratch)  # (1 - b2) g^2 + b2 nu
        t = np.float32(count)
        bc1 = float(np.float32(1) - np.float32(self.b1) ** t)
        bc2 = float(np.float32(1) - np.float32(self.b2) ** t)
        den = scratch
        torch._foreach_copy_(den, nu)
        torch._foreach_div_(den, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)  # sqrt(nu / bc2) + eps
        upd = grads
        torch._foreach_copy_(upd, mu)
        torch._foreach_div_(upd, bc1)
        torch._foreach_div_(upd, den)  # (mu / bc1) / den
        decayed = [i for i, n in enumerate(names) if _decays(n)]
        if decayed and self.weight_decay:
            wd = [scratch[i] for i in decayed]
            torch._foreach_copy_(wd, [params[i] for i in decayed])
            torch._foreach_mul_(wd, self.weight_decay)
            torch._foreach_add_([upd[i] for i in decayed], wd)  # u + wd p
        torch._foreach_mul_(upd, -self.learning_rate)
        torch._foreach_add_(params, upd)


def make_optimizer(
    learning_rate: float = 1e-5, weight_decay: float = 0.2,
    b1: float = 0.9, b2: float = 0.98, eps: float = 1e-6,
    grad_clip: float = 1.0,
) -> ClippedAdamW:
    """AdamW with the CLIP-paper hyperparameter shape; decay masked off
    LayerNorm gains, biases, and logit_scale (CLIP convention)."""
    return ClippedAdamW(learning_rate, weight_decay, b1, b2, eps, grad_clip)


def make_train_step(spec: CLIPModelSpec, optimizer: ClippedAdamW,
                    compute_dtype: torch.dtype = torch.float32,
                    remat: bool = True):
    """(model, opt_state, images, tokens) -> loss, updating ``model`` and
    ``opt_state`` in place. ``model`` is a :class:`CLIP` or a
    ``ShardedCLIP`` (then the batch is split over the data axis, unless
    given as ``ShardedTensor``s placed by ``batch_shardings``)."""
    if getattr(spec, "family", "vit") == "resnet":
        # The RN* towers run inference-mode BatchNorm (models/resnet.py):
        # training them would need batch-stats updates and the running
        # mean/var masked out of the optimizer. The JAX package refuses
        # them too, so fine-tuning stays ViT-only.
        raise NotImplementedError(
            "contrastive training supports the ViT family only; the "
            f"ResNet tower ({spec.name}) uses frozen inference BatchNorm"
        )

    def train_step(model, opt_state: AdamState, images: torch.Tensor,
                   tokens: torch.Tensor) -> torch.Tensor:
        model.zero_grad()  # gradients to None
        loss = clip_loss(model, images, tokens, compute_dtype, remat)
        loss.backward()
        optimizer.update(model, opt_state)
        return loss.detach()

    return train_step
