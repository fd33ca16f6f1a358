"""Per-layer metric ``rn_epilogue_fused_share.index``: see ``read``."""

LAYER = "kernels"
UNIT = "%"
BETTER = "higher"
SOURCE = "program_counter"
MOVES = "index_card_images_per_s"


def read(ctx: dict):
    """Share of the modified ResNet's conv-epilogue chains run on the card
    over the window that took a fused kernel: the program's
    ``rn_epilogue_fused_launches`` over those plus
    ``rn_epilogue_plain_cuda_calls`` (the chains on a CUDA tensor that
    took the plain torch ops). A program without those counters, or a
    tower without such chains, reads nothing."""
    if ctx["kind"] != "index":
        return None
    counters = ctx["window"]["counters"]
    fused = counters.get("rn_epilogue_fused_launches", 0.0)
    plain = counters.get("rn_epilogue_plain_cuda_calls", 0.0)
    if fused + plain <= 0:
        return None
    return 100.0 * fused / (fused + plain)
