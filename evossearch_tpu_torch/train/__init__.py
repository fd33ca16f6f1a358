from .contrastive import (
    AdamState,
    ClippedAdamW,
    clip_loss,
    decay_mask,
    make_optimizer,
    make_train_step,
)
from .data import PairDataset
from .loop import fit, retrieval_accuracy

__all__ = [
    "AdamState",
    "ClippedAdamW",
    "PairDataset",
    "clip_loss",
    "decay_mask",
    "fit",
    "make_optimizer",
    "make_train_step",
    "retrieval_accuracy",
]
