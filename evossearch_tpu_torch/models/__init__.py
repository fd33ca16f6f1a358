from .checkpoint import load_model, load_params, params_from_numpy, save_params
from .clip import CLIP, encode_image, encode_text
from .layers import TowerConfig, quick_gelu

__all__ = [
    "CLIP",
    "encode_image",
    "encode_text",
    "load_model",
    "load_params",
    "params_from_numpy",
    "save_params",
    "TowerConfig",
    "quick_gelu",
]
