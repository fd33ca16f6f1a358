from .checkpoint import (
    load_model,
    load_params,
    params_from_numpy,
    params_to_numpy,
    save_params,
)
from .clip import (
    CLIP,
    count_params,
    embed_image,
    embed_text,
    encode_image,
    encode_text,
    expected_param_count,
    init_params,
)
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
    "count_params",
    "expected_param_count",
    "embed_image",
    "embed_text",
    "encode_image",
    "encode_text",
    "from_hf_state_dict",
    "from_openai_state_dict",
    "infer_openai_resnet_spec",
    "infer_openai_spec",
    "init_params",
    "load_checkpoint",
    "load_model",
    "load_params",
    "params_from_numpy",
    "params_to_numpy",
    "save_params",
    "TowerConfig",
    "quick_gelu",
]
