from .pipeline import (
    DEFAULT_MAX_SIDE,
    device_preprocess,
    device_preprocess_indexed,
    prepare_batch,
)
from .resize import (
    clip_resize_crop_matrices,
    resample_matrix,
    resized_dims,
)

__all__ = [
    "DEFAULT_MAX_SIDE",
    "device_preprocess",
    "device_preprocess_indexed",
    "prepare_batch",
    "clip_resize_crop_matrices",
    "resample_matrix",
    "resized_dims",
]
