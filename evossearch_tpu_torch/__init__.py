"""evossearch_tpu_torch — the PyTorch + CUDA port of evossearch_tpu.

CLIP-based natural-language and image-to-image search over local photo
folders, running on one NVIDIA GPU (Hopper, sm_90a) unless the caller
asks for the CPU. ``evossearch_tpu`` (JAX) is the reference this package
is tested against; it never imports it.

Layer map (bottom-up):
    core/        model constants, config (EVOSSEARCH_* env surface)
    tokenizer/   byte-BPE CLIP text tokenizer (host-side)
    models/      CLIP image+text towers (torch modules; ViT and modified-
                 ResNet image towers), npz checkpoints, OpenAI /
                 HuggingFace checkpoint converters
    native       C++ host extension (threaded exact scan, libjpeg decode),
                 built with g++ at first use
    preprocess/  native planar/RGB or Pillow decode + resample/center-crop/
                 normalize GEMMs (and YCbCr->RGB for planar batches)
    ops/         hand-written CUDA top-k candidate kernels + merge glue
    index/       memory-mapped embedding shard store, builder, exact
                 search, SQ8 and IVF tiers
    server/      stdlib WSGI micro-framework + HTTP API + SPA frontend
    utils/       structured logging, timing, torch.profiler hooks
    __main__     the CLI (python -m evossearch_tpu_torch)
"""

__version__ = "0.1.0"


def __getattr__(name):
    # Lazy top-level exports: importing the package loads no torch code.
    if name == "SearchEngine":
        from .engine import SearchEngine

        return SearchEngine
    if name == "Config":
        from .core import Config

        return Config
    if name == "create_app":
        from .server import create_app

        return create_app
    raise AttributeError(f"module 'evossearch_tpu_torch' has no attribute {name!r}")
