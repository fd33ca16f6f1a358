"""The mesh half of training — the port's counterpart of the sharding half
of ``evossearch_tpu/train/contrastive.py`` (``train_mesh``,
``clip_param_specs``, ``clip_param_shardings``, ``batch_shardings``), and
of the collectives XLA inserts for it.

A train mesh is a 2-D (data, model) ``parallel.mesh.DeviceMesh``. One
process drives every position, as the JAX package's mesh does (no
``torch.distributed`` group), and a device may repeat: ``[cuda:0] * 4``
runs four positions on one card, ``[cpu] * 8`` stands in for the JAX
tests' 8 forced host devices.

    params      ``ShardedCLIP``: each leaf of the JAX param pytree (block
                leaves stacked ``(L, ...)``, as ``save_params`` writes
                them) as a ``ShardedTensor`` laid out by
                ``clip_param_specs``: position (d, m) holds the slice the
                JAX array's addressable shard holds on the same mesh shape,
                in its own storage; a replicated leaf is one copy per
                position
    batch       split over the data axis (``batch_shardings``): row d of
                the mesh computes its slice of the batch, every model rank
                of that row holds the same slice
    towers      Megatron tensor parallelism over the model axis, computed
                from the shards with autograd (and remat, per block):
                every rank carries the residual stream with its own copies
                of the replicated leaves; ``wqkv``/``bqkv`` and
                ``w1``/``b1`` are split on the output dim, ``wo`` and
                ``w2`` on the input dim, their float32 partial products
                summed over the ranks in rank order before the replicated
                bias is added once and the result cast; the patch
                embedding's output slices are gathered before the class
                token is concatenated
    loss        the embeddings of every data row gathered onto the first
                position, so the InfoNCE holds every negative of the
                global batch
    gradients   ``reduce_gradients``: each slice's gradient summed over the
                positions that hold it (the data axis for a model-split
                leaf, every position for a replicated one, which is what
                the chain rule gives for tied copies), written back to
                every holder, and the global norm of the logical gradient
                with each element counted once

The fused qkv split is not head-aligned: rank m's contiguous slice of the
3W outputs holds parts of q, k and v of different heads. The shards stay
the JAX package's slices (its ``train/contrastive.py:131-133`` accepts
the same extra collective); the activations are regrouped instead: every rank
gathers the qkv slices and attends over its own heads, whose outputs are
exactly the rows of ``wo`` it holds.

Differences from the JAX package, none of them a fault: the summation
order of a split product (partial sums over ranks, not one dot), and the
placement of the sharded state, whose checkpoint format is the port's own
(``models.checkpoint.save_sharded``).
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from ..core.constants import CLIPModelSpec
from ..core.device import resolve_device
from ..models.checkpoint import _flatten, _unflatten, params_from_numpy, tree_items, tree_key
from ..models.clip import CLIP, _l2_normalize, _patch_embed
from ..models.layers import _dense, attend, layer_norm, matmul_f32, quick_gelu
from ..parallel.mesh import DeviceMesh, ShardedTensor, Sharding, available_devices

DATA_AXIS = "data"
MODEL_AXIS = "model"


# ---------------------------------------------------------------- shardings


def _tower_specs() -> dict:
    """Specs for one stacked transformer tower (leading dim = layer).

    Megatron-style tensor parallel: qkv/fc1 shard the OUTPUT feature dim,
    out_proj/fc2 shard the INPUT feature dim, so each block needs one sum
    over the model axis per sublayer (and one gather of the fused qkv,
    whose shards are not head-aligned)."""
    return {
        "ln_1": {"scale": (None, None), "bias": (None, None)},
        "attn": {
            "wqkv": (None, None, MODEL_AXIS), "bqkv": (None, MODEL_AXIS),
            "wo": (None, MODEL_AXIS, None), "bo": (None, None),
        },
        "ln_2": {"scale": (None, None), "bias": (None, None)},
        "mlp": {
            "w1": (None, None, MODEL_AXIS), "b1": (None, MODEL_AXIS),
            "w2": (None, MODEL_AXIS, None), "b2": (None, None),
        },
    }


def clip_param_specs() -> dict:
    """The spec of every leaf of the ViT CLIP param pytree (the JAX
    package's naming): one axis name or None per dimension."""
    return {
        "visual": {
            "patch_embed": {"kernel": (None, MODEL_AXIS)},
            "class_embedding": (None,),
            "pos_embed": (None, None),
            "ln_pre": {"scale": (None,), "bias": (None,)},
            "blocks": _tower_specs(),
            "ln_post": {"scale": (None,), "bias": (None,)},
            "proj": (None, None),
        },
        "text": {
            "token_embed": (None, None),
            "pos_embed": (None, None),
            "blocks": _tower_specs(),
            "ln_final": {"scale": (None,), "bias": (None,)},
            "proj": (None, None),
        },
        "logit_scale": (),
    }


def _map_specs(fn, tree: dict) -> dict:
    return {k: _map_specs(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def clip_param_shardings(mesh: DeviceMesh) -> dict:
    """The ``Sharding`` of every param leaf on ``mesh``, as a pytree."""
    return _map_specs(lambda spec: Sharding(mesh, spec), clip_param_specs())


def batch_shardings(mesh: DeviceMesh) -> tuple[Sharding, Sharding]:
    """(images, tokens) shardings: batch split over the data axis."""
    return (Sharding(mesh, (DATA_AXIS, None, None, None)),
            Sharding(mesh, (DATA_AXIS, None)))


def train_mesh(n_devices: int = 0, model_parallel: int = 1,
               devices=None) -> DeviceMesh:
    """(data, model) mesh over ``devices`` (repeats allowed), by default
    every visible card; the first ``n_devices`` of them where given."""
    if devices is None:
        devices = available_devices(resolve_device(None))
    devices = [torch.device(d) for d in devices]
    if n_devices:
        devices = devices[:n_devices]
    n = len(devices)
    if not n or n % model_parallel:
        raise ValueError(f"{n} devices not divisible by tp={model_parallel}")
    rows = [tuple(devices[i : i + model_parallel]) for i in range(0, n, model_parallel)]
    return DeviceMesh(tuple(rows), (DATA_AXIS, MODEL_AXIS))


# ------------------------------------------------------------ sharded model


class _StackedLayers:
    """A stacked ``(L, ...)`` leaf over per-layer tensors, sliced without
    stacking the whole leaf (for ``Sharding.place``)."""

    def __init__(self, layers: list[torch.Tensor]):
        self.layers = layers
        self.shape = (len(layers), *layers[0].shape)

    def __getitem__(self, index):
        return torch.stack([t.detach()[index[1:]] for t in self.layers[index[0]]])


def _param_shapes(spec: CLIPModelSpec) -> dict[str, tuple[int, ...]]:
    """Tree key -> shape of every leaf of the param pytree (stacked)."""
    with torch.device("meta"):
        model = CLIP(spec)
    shapes: dict[str, tuple[int, ...]] = {}
    counts: dict[str, int] = {}
    for name, p in model.named_parameters():
        key, layer = tree_key(name)
        shapes[key] = tuple(p.shape)
        if layer is not None:
            counts[key] = counts.get(key, 0) + 1
    return {k: (counts[k], *s) if k in counts else s for k, s in shapes.items()}


class ShardedCLIP:
    """A ViT CLIP's parameters laid out on a train mesh:
    ``params[tree_key]`` is a ``ShardedTensor`` of the JAX pytree's leaf
    (block leaves stacked), each shard a leaf tensor with autograd."""

    def __init__(self, spec: CLIPModelSpec, mesh: DeviceMesh,
                 params: dict[str, ShardedTensor]):
        self.spec = spec
        self.mesh = mesh
        self.params = params

    @classmethod
    def place(cls, params, mesh: DeviceMesh, spec: CLIPModelSpec | None = None) -> "ShardedCLIP":
        """``params`` (a :class:`CLIP` module, or the JAX package's param
        pytree of numpy leaves with its ``spec``) on ``mesh`` by
        ``clip_param_specs``. Each position's slice is cut from the source
        and copied to its device: no full-size copy of a sharded leaf."""
        if isinstance(params, CLIP):
            spec = params.spec
            grouped: dict[str, dict[int, torch.Tensor]] = {}
            sources = {}
            for name, p in params.named_parameters():
                key, layer = tree_key(name)
                if layer is None:
                    sources[key] = p
                else:
                    grouped.setdefault(key, {})[layer] = p
            for key, layers in grouped.items():
                sources[key] = _StackedLayers([layers[i] for i in range(len(layers))])
        else:
            sources = _flatten(params)
        if spec is None or spec.family == "resnet":
            raise NotImplementedError(
                "sharded training supports the ViT family only (and needs its spec)")
        shardings = tree_items(clip_param_shardings(mesh))
        shapes = _param_shapes(spec)
        if set(sources) != set(shapes):
            raise ValueError(f"params do not match {spec.name}: "
                             f"{sorted(set(sources) ^ set(shapes))}")
        placed = {}
        for key in sorted(shapes):
            if tuple(sources[key].shape) != shapes[key]:
                raise ValueError(f"{key}: shape {tuple(sources[key].shape)}, "
                                 f"{spec.name} has {shapes[key]}")
            leaf = shardings[key].place(sources[key])
            for shard in leaf.shards:
                shard.requires_grad_(True)
            placed[key] = leaf
        return cls(spec, mesh, placed)

    @classmethod
    def abstract(cls, spec: CLIPModelSpec, mesh: DeviceMesh) -> "ShardedCLIP":
        """Shapes and shardings without data: a target to restore into."""
        shardings = tree_items(clip_param_shardings(mesh))
        return cls(spec, mesh, {k: ShardedTensor(shardings[k], shape, torch.float32)
                                for k, shape in sorted(_param_shapes(spec).items())})

    def tree(self) -> dict:
        return _unflatten(self.params)

    def from_tree(self, tree: dict) -> "ShardedCLIP":
        leaves = tree_items(tree)
        for leaf in leaves.values():
            for shard in leaf.shards:
                shard.requires_grad_(True)
        return ShardedCLIP(self.spec, next(iter(leaves.values())).sharding.mesh, leaves)

    def at(self, position: int) -> dict[str, torch.Tensor]:
        """Tree key -> position's shard."""
        return {k: v.shards[position] for k, v in self.params.items()}

    def zero_grad(self) -> None:
        for leaf in self.params.values():
            for shard in leaf.shards:
                shard.grad = None

    def to_numpy(self) -> dict:
        """The gathered param pytree: float32 numpy leaves, block leaves
        stacked (what ``save_params`` writes)."""
        return _unflatten({k: v.gather().float().numpy() for k, v in self.params.items()})

    def gather_grads(self, device: str | torch.device = "cpu") -> dict[str, torch.Tensor]:
        """Tree key -> the gathered gradient on ``device`` (after
        ``reduce_gradients``: the logical gradient); a shard with no
        gradient counts as zeros."""
        out = {}
        for key, leaf in self.params.items():
            grads = [s.grad if s.grad is not None else torch.zeros_like(s) for s in leaf.shards]
            out[key] = ShardedTensor(leaf.sharding, leaf.shape, leaf.dtype, grads).gather(device)
        return out

    def gather(self, device: str | torch.device | None = None) -> CLIP:
        """The whole model as a :class:`CLIP` on ``device`` (default the
        mesh's first device)."""
        return params_from_numpy(self.to_numpy(), self.spec, device or self.mesh.device(0))


# --------------------------------------------------------------- the towers

_BLOCK_LEAVES = ("ln_1/scale", "ln_1/bias", "attn/wqkv", "attn/bqkv", "attn/wo",
                 "attn/bo", "ln_2/scale", "ln_2/bias", "mlp/w1", "mlp/b1",
                 "mlp/w2", "mlp/b2")


def _layers(p: dict[str, torch.Tensor], tower: str) -> list[dict[str, torch.Tensor]]:
    """One rank's per-layer views of its stacked block shards (one unbind
    per leaf, so the backward stacks each leaf's gradient once)."""
    cols = {leaf: p[f"{tower}/blocks/{leaf}"].unbind(0) for leaf in _BLOCK_LEAVES}
    n = len(cols[_BLOCK_LEAVES[0]])
    return [{leaf: cols[leaf][layer] for leaf in _BLOCK_LEAVES} for layer in range(n)]


def _all_gather(parts: list[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The ranks' slices of the last dim, joined in rank order on ``device``."""
    return torch.cat([a.to(device) for a in parts], dim=-1)


def _row_parallel(partials: list[torch.Tensor], biases: list[torch.Tensor],
                  dtype: torch.dtype) -> list[torch.Tensor]:
    """Each rank's float32 partial products summed on every rank in rank
    order, the rank's replicated bias added once, then the one cast to the
    compute dtype (``_dense``'s arithmetic on a split product)."""
    out = []
    for bias in biases:
        total = partials[0].to(bias.device)
        for part in partials[1:]:
            total = total + part.to(bias.device)
        out.append((total + bias.float()).to(dtype))
    return out


def _tp_block(lps: list[dict[str, torch.Tensor]], xs: list[torch.Tensor],
              heads: int, causal: bool) -> list[torch.Tensor]:
    """One pre-LN block of one data row over the model axis: ``xs[m]`` is
    the residual stream on rank m, ``lps[m]`` rank m's shards."""
    ranks = len(xs)
    if heads % ranks:
        raise ValueError(f"{heads} heads do not split over {ranks} model ranks")
    b, t, w = xs[0].shape
    dtype = xs[0].dtype
    own = w // ranks  # rank m's heads: columns [m * own, (m + 1) * own) of q, k, v
    qkv = [_dense(layer_norm(x, p["ln_1/scale"], p["ln_1/bias"]), p["attn/wqkv"], p["attn/bqkv"])
           for p, x in zip(lps, xs)]
    partials = []
    for m, p in enumerate(lps):
        full = _all_gather(qkv, xs[m].device)  # regroup: this rank's heads
        q, k, v = (full[..., i * w + m * own : i * w + (m + 1) * own]
                   .reshape(b, t, heads // ranks, w // heads).transpose(1, 2) for i in range(3))
        out = attend(q, k, v, causal).transpose(1, 2).reshape(b, t, own)
        partials.append(matmul_f32(out, p["attn/wo"].to(dtype)))
    xs = [x + y for x, y in zip(xs, _row_parallel(partials, [p["attn/bo"] for p in lps], dtype))]
    partials = [
        matmul_f32(quick_gelu(_dense(layer_norm(x, p["ln_2/scale"], p["ln_2/bias"]),
                                     p["mlp/w1"], p["mlp/b1"])), p["mlp/w2"].to(dtype))
        for p, x in zip(lps, xs)
    ]
    return [x + y for x, y in zip(xs, _row_parallel(partials, [p["mlp/b2"] for p in lps], dtype))]


def _run_blocks(layers: list[list[dict]], xs: list[torch.Tensor], heads: int,
                causal: bool, remat: bool) -> list[torch.Tensor]:
    """The tower's blocks over the ranks; ``remat`` recomputes each block
    (all ranks of the row together) in the backward pass."""
    for layer in range(len(layers[0])):
        block = functools.partial(_tp_block, [rank[layer] for rank in layers],
                                  heads=heads, causal=causal)
        if remat and torch.is_grad_enabled():
            xs = list(checkpoint(lambda *a, f=block: tuple(f(list(a))), *xs,
                                 use_reentrant=False))
        else:
            xs = block(xs)
    return xs


def _image_row(ps: list[dict], images: list[torch.Tensor], spec: CLIPModelSpec,
               dtype: torch.dtype, remat: bool) -> torch.Tensor:
    """One data row's image embeddings (not normalized), float32, on its
    first rank's device."""
    patches = [_patch_embed(img.to(dtype), p["visual/patch_embed/kernel"], spec.patch_size)
               for p, img in zip(ps, images)]
    xs = []
    for p, img in zip(ps, images):
        x = _all_gather(patches, img.device).to(dtype)
        cls = p["visual/class_embedding"].to(dtype).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + p["visual/pos_embed"].to(dtype)
        xs.append(layer_norm(x, p["visual/ln_pre/scale"], p["visual/ln_pre/bias"]))
    xs = _run_blocks([_layers(p, "visual") for p in ps], xs, spec.vision_heads, False, remat)
    p = ps[0]
    pooled = layer_norm(xs[0][:, 0, :], p["visual/ln_post/scale"], p["visual/ln_post/bias"])
    return pooled.float() @ p["visual/proj"].float()


def _text_row(ps: list[dict], tokens: list[torch.Tensor], spec: CLIPModelSpec,
              dtype: torch.dtype, remat: bool) -> torch.Tensor:
    """One data row's text embeddings (not normalized), float32, on its
    first rank's device."""
    xs = [p["text/token_embed"][tok.long()].to(dtype) + p["text/pos_embed"].to(dtype)
          for p, tok in zip(ps, tokens)]
    xs = _run_blocks([_layers(p, "text") for p in ps], xs, spec.text_heads, True, remat)
    p, tok = ps[0], tokens[0]
    x = layer_norm(xs[0], p["text/ln_final/scale"], p["text/ln_final/bias"]).float()
    pooled = x[torch.arange(x.shape[0], device=x.device), tok.argmax(dim=-1)]
    return pooled @ p["text/proj"].float()


def sharded_embeddings(model: ShardedCLIP, images, tokens,
                       compute_dtype: torch.dtype = torch.float32,
                       remat: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """(image, text) embeddings of the global batch, float32 and
    L2-normalized, gathered in data-row order on the mesh's first device,
    with autograd. ``images`` and ``tokens`` are whole-batch tensors
    (split here by ``batch_shardings``) or ``ShardedTensor``s placed so."""
    mesh = model.mesh
    img_sharding, tok_sharding = batch_shardings(mesh)
    if not isinstance(images, ShardedTensor):
        images = img_sharding.place(images)
    if not isinstance(tokens, ShardedTensor):
        tokens = tok_sharding.place(tokens)
    lead = mesh.device(0)
    ranks = mesh.shape[MODEL_AXIS]
    img_rows, txt_rows = [], []
    for row in range(mesh.shape[DATA_AXIS]):
        positions = range(row * ranks, (row + 1) * ranks)
        ps = [model.at(pos) for pos in positions]
        img = _image_row(ps, [images.shards[pos] for pos in positions], model.spec,
                         compute_dtype, remat)
        txt = _text_row(ps, [tokens.shards[pos] for pos in positions], model.spec,
                        compute_dtype, remat)
        img_rows.append(_l2_normalize(img).to(lead))
        txt_rows.append(_l2_normalize(txt).to(lead))
    return torch.cat(img_rows), torch.cat(txt_rows)


# --------------------------------------------------------------- gradients


@torch.no_grad()
def reduce_gradients(model: ShardedCLIP) -> torch.Tensor:
    """Sum each slice's gradient over the positions that hold it, in
    position order, and write the sum to every holder's ``.grad`` (a
    position whose copy took no part in the loss holds a zero gradient);
    return the global norm of the logical gradient, each element counted
    once, as a 0-d float32 tensor on the mesh's first device."""
    lead = model.mesh.device(0)
    norms = []
    for leaf in model.params.values():
        for group in leaf.sharding.groups(leaf.shape):
            shards = [leaf.shards[pos] for pos in group]
            total = None
            for shard in shards:
                if shard.grad is not None:
                    total = shard.grad if total is None else total.add_(shard.grad.to(total.device))
            if total is None:
                total = torch.zeros_like(shards[0])
            for shard in shards:
                if shard.grad is total:
                    continue
                if shard.grad is None:
                    shard.grad = total.to(shard.device, copy=True)
                else:
                    shard.grad.copy_(total)
            norms.append(torch.linalg.vector_norm(total).to(lead))
    return torch.linalg.vector_norm(torch.stack(norms))
