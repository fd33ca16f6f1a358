from .pipeline import (
    DEFAULT_MAX_SIDE,
    device_preprocess,
    device_preprocess_indexed,
    device_preprocess_planar,
    device_preprocess_planar_indexed,
    planar_to_rgb_host,
    prepare_batch,
    prepare_batch_planar,
)
from .resize import (
    clip_resize_crop_chroma_matrices,
    clip_resize_crop_matrices,
    resample_matrix,
    resized_dims,
)

__all__ = [
    "DEFAULT_MAX_SIDE",
    "device_preprocess",
    "device_preprocess_indexed",
    "device_preprocess_planar",
    "device_preprocess_planar_indexed",
    "planar_to_rgb_host",
    "prepare_batch",
    "prepare_batch_planar",
    "clip_resize_crop_chroma_matrices",
    "clip_resize_crop_matrices",
    "resample_matrix",
    "resized_dims",
]
