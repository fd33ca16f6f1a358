from .checkpoint import load_model, load_params, params_from_numpy, save_params
from .clip import CLIP, encode_image, encode_text, expected_param_count
from .convert import (
    from_hf_state_dict,
    from_openai_state_dict,
    infer_openai_resnet_spec,
    infer_openai_spec,
    load_checkpoint,
)
from .layers import TowerConfig, quick_gelu

__all__ = [
    "CLIP",
    "expected_param_count",
    "encode_image",
    "encode_text",
    "from_hf_state_dict",
    "from_openai_state_dict",
    "infer_openai_resnet_spec",
    "infer_openai_spec",
    "load_checkpoint",
    "load_model",
    "load_params",
    "params_from_numpy",
    "save_params",
    "TowerConfig",
    "quick_gelu",
]
