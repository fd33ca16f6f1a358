"""Per-layer metric ``rn_epilogue_share.index``: see ``read``."""

from portbench.metrics import _epilogue

LAYER = "model step"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "index_card_images_per_s"


def read(ctx: dict):
    """Share of the traced sub-window's busy seconds (the union of device
    spans) spent in the modified ResNet's conv epilogue ops, classed by
    ``_epilogue.is_epilogue``'s name rule. Nothing where the program
    counted no ``rn_epilogue_passes`` in the sub-window (a ViT tower, or
    a program without the counter)."""
    if _epilogue.counted(ctx, _epilogue.PASSES) <= 0:
        return None
    trace = ctx["trace"]
    if trace["busy_s"] <= 0:
        return None
    return 100.0 * _epilogue.epilogue_s(trace) / trace["busy_s"]
