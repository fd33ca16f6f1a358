"""Per-layer metric ``tower_fused_share.index``: see ``read``."""

LAYER = "model step"
UNIT = "%"
BETTER = "higher"
SOURCE = "program_counter"
MOVES = "index_card_images_per_s"


def read(ctx: dict):
    """Share of the towers' elementwise chains run on the card over the
    window that took a fused kernel: the program's
    ``tower_fused_launches`` over those plus ``tower_plain_cuda_calls``
    (the calls on a CUDA tensor that took the plain torch ops). A program
    without those counters reads nothing."""
    if ctx["kind"] != "index":
        return None
    counters = ctx["window"]["counters"]
    fused = counters.get("tower_fused_launches", 0.0)
    plain = counters.get("tower_plain_cuda_calls", 0.0)
    if fused + plain <= 0:
        return None
    return 100.0 * fused / (fused + plain)
