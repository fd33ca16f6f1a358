"""The port's device rule: the first GPU unless the caller asks for
another device; with no GPU a caller must ask for the CPU explicitly."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``device`` as given, else the first GPU; raises with no GPU and no
    explicit device. A bare ``"cuda"`` becomes the current GPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: pass device='cpu' to run on "
                "the CPU"
            )
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device
