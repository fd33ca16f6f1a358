"""Per-layer metric ``device_idle.index``: see ``read``."""

LAYER = "device"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "index_card_images_per_s"


def read(ctx: dict):
    """Share of the traced sub-window in which no kernel, copy or memset
    ran on the card."""
    trace = ctx.get("trace")
    if ctx["kind"] != "index" or not trace or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
