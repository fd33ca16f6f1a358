"""Device meshes — PyTorch counterpart of ``evossearch_tpu/parallel/mesh.py``.

A mesh is a 1-D list of devices; each holds one contiguous row block of
the corpus ("corpus sharding"). One process drives every device, as the
JAX package's mesh does: each block runs the port's single-device route,
and the blocks' candidates merge under the (score desc, row asc)
contract. No ``torch.distributed`` process group is involved.

A device may repeat: ``[cuda:0] * 4`` is four row blocks on one card, and
``[cpu] * 8`` stands in on the CPU for the JAX tests' 8 forced host
devices.

Training uses a 2-D mesh with named axes (``DeviceMesh``), the port's
counterpart of ``jax.sharding.Mesh``: a ``Sharding`` (mesh and spec: one
axis name or None per dimension, as a ``PartitionSpec``) says which
contiguous slice of a tensor each position holds, and a ``ShardedTensor``
holds one tensor of that slice per position, each its own storage on its
position's device (a replicated slice is one copy per position).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.device import resolve_device

CORPUS_AXIS = "shard"


@dataclass(frozen=True)
class Mesh:
    devices: tuple[torch.device, ...]
    axis: str = CORPUS_AXIS

    @property
    def size(self) -> int:
        """Row blocks of the corpus (the JAX mesh's ``devices.size``)."""
        return len(self.devices)


def available_devices(device: str | torch.device) -> list[torch.device]:
    """Every device an engine on ``device`` may shard over: each visible
    card for a CUDA device, the CPU alone for a CPU device."""
    device = torch.device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [device]


def corpus_mesh(n_devices: int = 0, devices=None) -> Mesh:
    """1-D mesh over the first ``n_devices`` of ``devices`` (0 = all; a
    count above what exists gives fewer), by default every visible card
    (with no GPU a caller passes its devices)."""
    if devices is None:
        devices = available_devices(resolve_device(None))
    devices = [torch.device(d) for d in devices]
    if n_devices:
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return Mesh(tuple(devices))


@dataclass(frozen=True)
class DeviceMesh:
    """A 2-D grid of devices with named axes: ``devices[i][j]`` is the
    device at position (i, j) along ``axis_names``. Positions are also
    numbered row-major (``i * cols + j``), the order every per-position
    list here follows."""

    devices: tuple[tuple[torch.device, ...], ...]
    axis_names: tuple[str, str]

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size (the JAX mesh's ``shape``)."""
        return {self.axis_names[0]: len(self.devices),
                self.axis_names[1]: len(self.devices[0])}

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])

    def coords(self, position: int) -> tuple[int, int]:
        return divmod(position, len(self.devices[0]))

    def device(self, position: int) -> torch.device:
        i, j = self.coords(position)
        return self.devices[i][j]


@dataclass(frozen=True)
class Sharding:
    """Where each position of ``mesh`` holds which slice of a tensor:
    dimension ``k`` is cut into ``mesh.shape[spec[k]]`` equal contiguous
    chunks along that axis, or kept whole where ``spec[k]`` is None (the
    JAX package's ``NamedSharding(mesh, PartitionSpec(*spec))``)."""

    mesh: DeviceMesh
    spec: tuple

    def index(self, shape, position: int) -> tuple[slice, ...]:
        """The slice of a tensor of ``shape`` that ``position`` holds (the
        JAX array's ``addressable_shards[i].index``, with whole dimensions
        as explicit bounds)."""
        if len(self.spec) != len(shape):
            raise ValueError(f"spec {self.spec} does not fit shape {tuple(shape)}")
        coords = self.mesh.coords(position)
        out = []
        for size, axis in zip(shape, self.spec):
            if axis is None:
                out.append(slice(0, size))
                continue
            parts = self.mesh.shape[axis]
            if size % parts:
                raise ValueError(f"dimension {size} does not split over the "
                                 f"{parts} positions of axis {axis!r}")
            at = coords[self.mesh.axis_names.index(axis)]
            out.append(slice(at * size // parts, (at + 1) * size // parts))
        return tuple(out)

    def groups(self, shape) -> list[list[int]]:
        """Positions that hold the same slice, each group in position
        order, groups in the order of their first position."""
        by_index: dict[tuple, list[int]] = {}
        for pos in range(self.mesh.size):
            key = tuple((s.start, s.stop) for s in self.index(shape, pos))
            by_index.setdefault(key, []).append(pos)
        return list(by_index.values())

    def place(self, x) -> "ShardedTensor":
        """A ``ShardedTensor`` of ``x`` (a tensor, a numpy array, or
        anything with ``shape`` whose ``[index]`` gives one): each
        position's slice is cut from ``x`` and copied into new storage on
        the position's device, so no full-size copy of ``x`` is made."""
        shape = tuple(x.shape)
        shards: list = [None] * self.mesh.size
        for group in self.groups(shape):
            part = x[self.index(shape, group[0])]
            if not isinstance(part, torch.Tensor):  # numpy: an array, or a 0-d leaf's scalar
                part = torch.from_numpy(np.array(part))
            part = part.detach()
            for pos in group:
                shards[pos] = torch.empty(part.shape, dtype=part.dtype,
                                          device=self.mesh.device(pos)).copy_(part)
        return ShardedTensor(self, shape, shards[0].dtype, shards)


@dataclass
class ShardedTensor:
    """One logical tensor of ``shape`` laid out on a mesh by ``sharding``:
    ``shards[p]`` is position ``p``'s slice on its device. With ``shards``
    None it is abstract: a shape, dtype and sharding to restore into (the
    JAX package's ``ShapeDtypeStruct`` with a sharding)."""

    sharding: Sharding
    shape: tuple[int, ...]
    dtype: torch.dtype
    shards: list[torch.Tensor] | None = None

    def zeros_like(self) -> "ShardedTensor":
        return ShardedTensor(self.sharding, self.shape, self.dtype,
                             [torch.zeros_like(s) for s in self.shards])

    def gather(self, device: str | torch.device = "cpu") -> torch.Tensor:
        """The whole tensor on ``device``, from one holder of each slice."""
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        for group in self.sharding.groups(self.shape):
            out[self.sharding.index(self.shape, group[0])] = self.shards[group[0]].detach()
        return out
