"""Hand-written CUDA kernels of the port and their plain versions."""
from .topk import fused_topk, fused_topk_batch, fused_topk_batch_tree, use_tree_kernel

__all__ = [
    "fused_topk",
    "fused_topk_batch",
    "fused_topk_batch_tree",
    "use_tree_kernel",
]
