from .constants import (
    CLIP_IMAGE_MEAN,
    CLIP_IMAGE_STD,
    CLIP_MODEL_SPECS,
    CLIPModelSpec,
    CLIPResNetSpec,
)
from .config import Config, config, load_env_file, write_env_file
from .device import resolve_device

__all__ = [
    "CLIP_IMAGE_MEAN",
    "CLIP_IMAGE_STD",
    "CLIP_MODEL_SPECS",
    "CLIPModelSpec",
    "CLIPResNetSpec",
    "Config",
    "config",
    "load_env_file",
    "resolve_device",
    "write_env_file",
]
