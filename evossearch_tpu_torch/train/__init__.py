from .contrastive import (
    DATA_AXIS,
    MODEL_AXIS,
    AdamState,
    ClippedAdamW,
    ShardedAdamState,
    batch_shardings,
    clip_loss,
    clip_param_shardings,
    clip_param_specs,
    decay_mask,
    make_optimizer,
    make_train_step,
    train_mesh,
)
from .data import PairDataset
from .loop import fit, retrieval_accuracy
from .sharded import ShardedCLIP

__all__ = [
    "AdamState",
    "ClippedAdamW",
    "DATA_AXIS",
    "MODEL_AXIS",
    "PairDataset",
    "ShardedAdamState",
    "ShardedCLIP",
    "batch_shardings",
    "clip_loss",
    "clip_param_shardings",
    "clip_param_specs",
    "decay_mask",
    "fit",
    "make_optimizer",
    "make_train_step",
    "retrieval_accuracy",
    "train_mesh",
]
