"""Device meshes — PyTorch counterpart of ``evossearch_tpu/parallel/mesh.py``.

A mesh is a 1-D list of devices; each holds one contiguous row block of
the corpus ("corpus sharding"). One process drives every device, as the
JAX package's mesh does: each block runs the port's single-device route,
and the blocks' candidates merge under the (score desc, row asc)
contract. No ``torch.distributed`` process group is involved.

A device may repeat: ``[cuda:0] * 4`` is four row blocks on one card, and
``[cpu] * 8`` stands in on the CPU for the JAX tests' 8 forced host
devices.
"""

from __future__ import annotations

from dataclasses import dataclass

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
