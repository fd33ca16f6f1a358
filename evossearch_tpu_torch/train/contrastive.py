"""Contrastive (CLIP-style) training on one device — PyTorch counterpart
of ``evossearch_tpu/train/contrastive.py``.

The loss is the symmetric InfoNCE over the batch, in float32, with the
towers run with autograd (``models.embed_image`` / ``embed_text``) and,
by default, each block recomputed in the backward pass (``remat``, the
JAX package's default too). The optimizer is optax's
``clip_by_global_norm(1.0)`` then AdamW with decay masked off gains,
biases and ``logit_scale``, written out here with optax's arithmetic in
optax's order, so its state is optax's ``ScaleByAdamState(count, mu, nu)``
one to one.

The mesh half of the JAX module (``train_mesh``, ``clip_param_specs``,
``clip_param_shardings``, ``batch_shardings``) is the training half of
ROADMAP A13, the next slice: ``parallel/`` holds only the search half,
and a sharded training state needs a checkpoint format of its own
(orbax, which the JAX package writes it with, imports JAX).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..core.constants import CLIPModelSpec
from ..models.clip import embed_image, embed_text

# Param leaf names excluded from weight decay (CLIP/AdamW convention: no
# decay on gains or biases; logit_scale is a temperature, not a weight).
_NO_DECAY_NAMES = frozenset(
    {"scale", "bias", "bqkv", "bo", "b1", "b2", "class_embedding",
     "logit_scale"}
)


def clip_loss(model, images: torch.Tensor, tokens: torch.Tensor,
              compute_dtype: torch.dtype = torch.float32,
              remat: bool = True) -> torch.Tensor:
    """Symmetric InfoNCE over the batch: a float32 scalar with autograd."""
    img_emb = embed_image(model, images, compute_dtype, remat)
    txt_emb = embed_text(model, tokens, compute_dtype, remat)
    # OpenAI clamps the learned temperature at 100.
    scale = torch.clamp(model.logit_scale.float().exp(), max=100.0)
    logits = scale * (img_emb @ txt_emb.T)
    labels = torch.arange(logits.shape[0], device=logits.device)
    return 0.5 * (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels))


def decay_mask(model) -> dict[str, bool]:
    """Parameter name -> whether AdamW weight decay applies, by the name's
    last part (kernels and embeddings only)."""
    return {name: name.rsplit(".", 1)[-1] not in _NO_DECAY_NAMES
            for name, _ in model.named_parameters()}


@dataclasses.dataclass
class AdamState:
    """optax's ``ScaleByAdamState``: the step count and the first and
    second moments, by parameter name."""

    count: int
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]


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

    def init(self, model) -> AdamState:
        zeros = {name: torch.zeros_like(p) for name, p in model.named_parameters()}
        return AdamState(0, zeros, {k: torch.zeros_like(v) for k, v in zeros.items()})

    @torch.no_grad()
    def update(self, model, state: AdamState) -> None:
        """One step from the parameters' ``.grad``; updates ``model`` and
        ``state`` in place. The gradients are consumed: each ``.grad``
        is overwritten with the step's update. Beside the parameters,
        gradients and moments, the step holds one scratch copy of the
        gradients, not one per intermediate."""
        names, params, grads = [], [], []
        for name, p in model.named_parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            names.append(name)
            params.append(p)
            grads.append(p.grad)
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        keep = norm < self.grad_clip
        one = torch.ones((), device=norm.device)
        # g / norm * grad_clip above the norm; g itself below (x / 1 * 1 is exact)
        torch._foreach_div_(grads, torch.where(keep, one, norm))
        if self.grad_clip != 1.0:
            torch._foreach_mul_(grads, torch.where(keep, one, one * self.grad_clip))
        mu = [state.mu[n] for n in names]
        nu = [state.nu[n] for n in names]
        scratch = torch._foreach_mul(grads, 1 - self.b1)
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, scratch)  # (1 - b1) g + b1 mu
        torch._foreach_copy_(scratch, grads)
        torch._foreach_mul_(scratch, grads)
        torch._foreach_mul_(scratch, 1 - self.b2)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, scratch)  # (1 - b2) g^2 + b2 nu
        state.count += 1
        t = np.float32(state.count)
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
        mask = decay_mask(model)
        decayed = [i for i, n in enumerate(names) if mask[n]]
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
    ``opt_state`` in place."""
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
        model.zero_grad(set_to_none=True)
        loss = clip_loss(model, images, tokens, compute_dtype, remat)
        loss.backward()
        optimizer.update(model, opt_state)
        return loss.detach()

    return train_step
