from .mesh import (
    CORPUS_AXIS,
    DeviceMesh,
    Mesh,
    ShardedTensor,
    Sharding,
    available_devices,
    corpus_mesh,
)
from .sharded_ivf import ShardedIVFIndex
from .sharded_search import ShardedIndex
from .sharded_sq8 import SQ8ShardedIndex

__all__ = [
    "CORPUS_AXIS", "DeviceMesh", "Mesh", "ShardedTensor", "Sharding",
    "available_devices", "corpus_mesh",
    "ShardedIndex", "ShardedIVFIndex", "SQ8ShardedIndex",
]
