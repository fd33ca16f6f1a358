"""Per-layer metric ``index_mfu``: see ``read``."""

from portbench import flops

LAYER = "model step"
UNIT = "%"
BETTER = "higher"
SOURCE = "program_counter"
MOVES = "index_card_images_per_s"


def read(ctx: dict):
    """The image tower's FLOPs for every image indexed in the window over
    the window's length on the host clock at the bf16 peak. The rate is not
    fixed here, so the window is the divisor; where the host paces the
    passes, the card's share of its peak while it runs is higher by the
    window's idle share."""
    if ctx["kind"] != "index" or ctx["elapsed_s"] <= 0:
        return None
    return 100.0 * ctx["images"] * flops.image_fwd_flops(ctx["model"]) / (
        ctx["elapsed_s"] * flops.PEAK_BF16_FLOPS)
