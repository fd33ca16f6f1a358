from .bpe import (
    CLIPTokenizer,
    bytes_to_unicode,
    load_hf_merges,
    load_openai_merges,
    load_tokenizer,
)

__all__ = [
    "CLIPTokenizer",
    "bytes_to_unicode",
    "load_hf_merges",
    "load_openai_merges",
    "load_tokenizer",
]
