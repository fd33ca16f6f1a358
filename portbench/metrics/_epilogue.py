"""The modified ResNet's conv epilogues in a reduced trace (shared by
``rn_epilogue_share.index`` and ``rn_epilogue_roofline.index``; not a
metric: the harness skips files whose name starts with ``_``).

The name rule: a device op of the trace is an epilogue op when it is a
kernel (not a ``Memcpy`` or ``Memset`` entry: copies between host and
card, or on the card, and fills) that is neither a convolution (its name holds
``conv2d``, ``convolve``, ``fprop`` or ``cudnn``, as cuDNN's
implicit-GEMM and cutlass fprop kernels do) nor a GEMM (``gemm``, ``gemv``, ``nvjet``,
``cublas`` or ``cutlass``). On the ResNet tower's path that leaves the
BatchNorm affines' casts, multiplies and adds, the ReLUs, the residual
adds and the average pools (torch's ``elementwise_kernel``,
``vectorized_elementwise_kernel``, ``unrolled_elementwise_kernel``,
``avg_pool2d_out_cuda_frame_nhwc``), and beside them the few small
kernels of the attention pool, the weights' casts and the preprocess.
"""

from __future__ import annotations

PASSES = "rn_epilogue_passes"
BYTES = "rn_epilogue_bytes"
CONV = ("conv2d", "convolve", "fprop", "cudnn")
GEMM = ("gemm", "gemv", "nvjet", "cublas", "cutlass")
NOT_KERNELS = ("Memcpy", "Memset")


def is_epilogue(name: str) -> bool:
    """Whether a device op of that name is an epilogue op (see above)."""
    if name.startswith(NOT_KERNELS):
        return False
    low = name.lower()
    return not any(k in low for k in CONV + GEMM)


def counted(ctx: dict, name: str) -> float:
    """The program's counter ``name`` over the traced sub-window, or 0
    where the run has no trace or the program no such counter."""
    trace = ctx.get("trace")
    if ctx["kind"] != "index" or not trace:
        return 0.0
    return trace["delta"]["counters"].get(name, 0.0)


def epilogue_s(trace: dict) -> float:
    """Device seconds of the sub-window's epilogue ops."""
    return sum(s for n, s in trace["device_ops"].items() if is_epilogue(n))
