"""What every family of hand-written elementwise kernels shares
(``ops/tower.py``, the ViT towers' chains; ``ops/rn_epilogue.py``, the
modified ResNet's conv epilogues): the route between a kernel and its
plain torch ops, the operand check, the launch, and the counting sink.

The route rule (``use_kernel``): a chain launches its kernel when its input
lies on a CUDA device, its compute dtype is bf16 and autograd records
nothing (grad mode off, or no operand requires grad): the engine's
encodes. The CPU, the meta device, float32 and training (autograd through
the plain ops) take the plain ops; a CUDA call that does counts under its
family's plain counter. ``on_card`` is the one device test: patching it
moves every family's chains onto the kernel route or off it.

While a thread is inside ``counting(counters)`` (the engine wraps each
tower call in it), ``count`` adds to those ``utils.logging.Counters``;
outside, nothing is counted. Nothing here synchronises.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_sink = threading.local()


@contextlib.contextmanager
def counting(counters):
    """Count this thread's chains into ``counters`` (an object with
    ``add(name, value)``; None counts nothing) while inside."""
    prev = getattr(_sink, "counters", None)
    _sink.counters = counters
    try:
        yield counters
    finally:
        _sink.counters = prev


def count(name: str, value: float = 1.0) -> None:
    """Add ``value`` to counter ``name`` of this thread's sink, if any."""
    counters = getattr(_sink, "counters", None)
    if counters is not None:
        counters.add(name, value)


def on_card(x: torch.Tensor) -> bool:
    return x.device.type == "cuda"


def use_kernel(x: torch.Tensor, dtype: torch.dtype, *operands: torch.Tensor,
               plain: str) -> bool:
    """Whether a chain on input ``x`` at compute dtype ``dtype``, with
    ``operands``, launches its kernel (see the module's docstring); counts
    a CUDA call that takes the plain ops under ``plain``."""
    if not on_card(x):
        return False
    recorded = torch.is_grad_enabled() and any(t.requires_grad for t in (x, *operands))
    if dtype == torch.bfloat16 and not recorded:
        return True
    count(plain)
    return False


def check(t: torch.Tensor, what: str, dtype: torch.dtype) -> None:
    """Refuse an operand that is not contiguous ``dtype`` on a 16-byte
    boundary."""
    if t.dtype != dtype:
        raise ValueError(f"{what} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{what} must be 16-byte aligned")


def launch(name: str, device: torch.device, args: list, counter: str) -> None:
    """Launch entry point ``name`` (``_build._SIGNATURES``) on ``device``'s
    current stream and count it under ``counter``; tensors in ``args``
    pass as their data pointers. The text tower at batch 1 is paced by
    these launches, so the stream is read raw and the device switched
    only when it differs."""
    from ._build import entry

    fn = entry(name)
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == current:
        rc = fn(*args, stream)
    else:
        with torch.cuda.device(index):
            rc = fn(*args, stream)
    if rc:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    count(counter)
