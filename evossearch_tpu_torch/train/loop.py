"""Training loop: contrastive fine-tuning with checkpointing and retrieval
eval — PyTorch counterpart of ``evossearch_tpu/train/loop.py``, on one
device or on a (data, model) mesh. Composes train/contrastive.py's step
with train/data.py's loader and models/checkpoint.py persistence.

Both checkpoint files are the JAX package's, so either package resumes
the other's run, on one device or on a mesh: ``clip.npz`` is
``save_params`` of the param pytree (blocks stacked into ``(L, ...)``
leaves), and ``train_state.npz`` holds optax's state leaves in
``jax.tree_util.tree_leaves`` order, ``opt_0`` the int32 step count, then
every ``mu`` leaf, then every ``nu`` leaf (the param tree's sorted-key
order), and ``epoch`` (int64). A mesh run writes both gathered, as the
JAX package's does.

Usage:
    model, history = fit(spec, dataset, epochs=3, checkpoint_dir="ckpts",
                         device="cuda")
    model, history = fit(spec, dataset, epochs=3, checkpoint_dir="ckpts",
                         mesh=train_mesh(model_parallel=2))
"""

from __future__ import annotations

import zipfile
from pathlib import Path

import numpy as np
import torch

from ..core.constants import CLIPModelSpec
from ..core.device import resolve_device
from ..models.checkpoint import (
    _unflatten,
    load_params,
    named_from_tree,
    params_from_numpy,
    params_to_numpy,
    save_params,
    tree_from_named,
    tree_key,
    tree_leaves,
)
from ..models.clip import CLIP, encode_image, encode_text
from ..preprocess import device_preprocess_indexed
from ..utils import get_logger
from .contrastive import AdamState, ShardedAdamState, make_optimizer, make_train_step
from .sharded import ShardedCLIP

log = get_logger("train")


def _to_device(batch, device: torch.device, compute_dtype: torch.dtype):
    """A PairDataset batch (numpy) -> (preprocessed images, tokens) on
    ``device``."""
    canv, a_h, a_w, idx, tokens = (torch.from_numpy(np.asarray(x)).to(device)
                                   for x in batch)
    images = device_preprocess_indexed(canv, a_h, a_w, idx, out_dtype=compute_dtype)
    return images, tokens


@torch.no_grad()
def retrieval_accuracy(model, spec: CLIPModelSpec, batches,
                       compute_dtype: torch.dtype = torch.float32) -> float:
    """Image->text top-1 retrieval accuracy within each batch (argmax:
    the first index among ties), on the model's device (a ``ShardedCLIP``
    gathered onto its mesh's first device)."""
    if isinstance(model, ShardedCLIP):
        model = model.gather()
    device = next(model.parameters()).device
    correct = total = 0
    for batch in batches:
        images, tokens = _to_device(batch, device, compute_dtype)
        img_emb = encode_image(model, images, compute_dtype)
        txt_emb = encode_text(model, tokens, compute_dtype)
        pred = (img_emb @ txt_emb.T).argmax(dim=1).cpu().numpy()
        correct += int((pred == np.arange(len(pred))).sum())
        total += len(pred)
    return correct / max(total, 1)


def _leaf_keys(model) -> list[str]:
    """The param pytree's flat keys (``visual/blocks/attn/wqkv``) in
    ``tree_leaves`` order, from the module's names."""
    keys = {tree_key(name)[0] for name, _ in model.named_parameters()}
    return tree_leaves(_unflatten({k: k for k in keys}))


def _save_train_state(path: Path, opt_state: AdamState | ShardedAdamState,
                      epoch: int) -> None:
    """optax's leaves: the count, the mu leaves, the nu leaves (gathered
    from a mesh)."""
    leaves = [np.asarray(opt_state.count, np.int32)]
    for moments in (opt_state.mu, opt_state.nu):
        if isinstance(opt_state, ShardedAdamState):
            tree = _unflatten({k: v.gather().numpy() for k, v in moments.items()})
        else:
            tree = tree_from_named({name: t.detach().cpu().numpy()
                                    for name, t in moments.items()})
        leaves += tree_leaves(tree)
    flat = {f"opt_{i}": leaf for i, leaf in enumerate(leaves)}
    flat["epoch"] = np.asarray(epoch, np.int64)
    np.savez(path, **flat)


def _load_train_state(path: Path, model) -> tuple[AdamState | ShardedAdamState | None, int]:
    """The optimizer state saved by either package's _save_train_state, on
    the model's device, or sharded like a ``ShardedCLIP``'s params (the
    template's placements: a moment is never held unsharded); (None, 0)
    on any mismatch (state from a different optimizer or model shape)."""
    sharded = isinstance(model, ShardedCLIP)
    params = model.params if sharded else dict(model.named_parameters())
    keys = tree_leaves(_unflatten({k: k for k in params})) if sharded else _leaf_keys(model)
    n = len(keys)
    try:
        with np.load(path, allow_pickle=False) as data:
            count = data["opt_0"]
            moments = [{k: data[f"opt_{first + i}"] for i, k in enumerate(keys)}
                       for first in (1, 1 + n)]
            epoch = int(data["epoch"])
    except (OSError, EOFError, KeyError, ValueError, zipfile.BadZipFile):
        return None, 0
    if not sharded:
        moments = [named_from_tree(_unflatten(m)) for m in moments]
    if count.shape != () or any(
        set(m) != set(params) or any(m[k].shape != tuple(params[k].shape) for k in m)
        for m in moments
    ):
        return None, 0
    if sharded:
        mu, nu = ({k: params[k].sharding.place(np.asarray(m[k], np.float32)) for k in params}
                  for m in moments)
        return ShardedAdamState(int(count), mu, nu), epoch
    mu, nu = ({k: torch.from_numpy(np.array(m[k], np.float32)).to(params[k].device)
               for k in params} for m in moments)
    return AdamState(int(count), mu, nu), epoch


def fit(
    spec: CLIPModelSpec,
    dataset,
    epochs: int = 1,
    learning_rate: float = 1e-5,
    params: CLIP | dict | None = None,
    checkpoint_dir: str | Path | None = None,
    resume: bool = False,
    mesh=None,
    compute_dtype: torch.dtype = torch.float32,
    seed: int = 0,
    log_every: int = 10,
    device: str | torch.device | None = None,
):
    """Train; returns (model, list of per-epoch mean losses).

    ``params`` is a :class:`CLIP` module, moved to ``device`` and trained
    in place, or the JAX package's param pytree (numpy leaves); None
    starts from ``checkpoint_dir``'s ``clip.npz`` when ``resume`` finds
    one, else from a random init seeded by ``seed`` (a torch generator:
    other numbers than the JAX package's init). A resume
    restores the optimizer state too and numbers its epochs after the
    saved one; a state that does not match starts a fresh optimizer from
    epoch 0. ``device`` as ``core.device.resolve_device`` resolves it.

    With a ``mesh`` (``train_mesh``), the params, or the resumed
    ``clip.npz``, are placed on it by ``clip_param_specs`` (the returned
    model is a ``ShardedCLIP``), the optimizer state is restored with the
    params' placements, each batch is preprocessed on the mesh's first
    device and split over the data axis, and both checkpoint files are
    written gathered; ``device`` is then unused."""
    device = mesh.device(0) if mesh is not None else resolve_device(device)
    ckpt = Path(checkpoint_dir) / "clip.npz" if checkpoint_dir else None
    state_ckpt = Path(checkpoint_dir) / "train_state.npz" if checkpoint_dir else None
    resumed = False
    if params is None:
        if resume and ckpt and ckpt.exists():
            params, loaded_spec = load_params(ckpt)
            if loaded_spec != spec:
                raise ValueError("checkpoint spec mismatch")
            resumed = True
            log.info("resumed from %s", ckpt)
        else:
            params = CLIP(spec).init_random_(torch.Generator().manual_seed(seed))
    if mesh is not None:
        model = ShardedCLIP.place(params, mesh, spec)
    elif isinstance(params, CLIP):
        model = params.to(device)
    else:
        model = params_from_numpy(params, spec, device)

    optimizer = make_optimizer(learning_rate=learning_rate)
    step = make_train_step(spec, optimizer, compute_dtype=compute_dtype)
    opt_state = optimizer.init(model)
    start_epoch = 0
    if resumed and state_ckpt and state_ckpt.exists():
        # resume restores the Adam moments too: re-initialized moments give
        # the first post-resume steps unscaled updates
        restored, saved_epoch = _load_train_state(state_ckpt, model)
        if restored is not None:
            opt_state = restored
            start_epoch = saved_epoch + 1  # continue numbering after it
            log.info("restored optimizer state from %s (epoch %d)",
                     state_ckpt, start_epoch)

    history = []
    for epoch in range(start_epoch, start_epoch + epochs):
        losses = []  # device scalars, fetched once per epoch
        for i, batch in enumerate(dataset.epoch()):
            images, tokens = _to_device(batch, device, compute_dtype)
            loss = step(model, opt_state, images, tokens)
            losses.append(loss)
            if i % log_every == 0:
                log.info("epoch %d step %d loss %.4f", epoch, i, float(loss))
        mean_loss = float(torch.stack(losses).mean()) if losses else float("nan")
        history.append(mean_loss)
        log.info("epoch %d done: mean loss %.4f", epoch, mean_loss)
        if ckpt:
            tree = model.to_numpy() if mesh is not None else params_to_numpy(model)
            save_params(ckpt, tree, spec)
            _save_train_state(state_ckpt, opt_state, epoch)
    return model, history
