"""Per-layer metric ``fill_ms_per_pass.index``: see ``read``."""

LAYER = "index pipeline"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "index_card_images_per_s"


def read(ctx: dict):
    """Mean time of the indexing pipeline's ``index_fill`` interval over the
    window's passes: from a pass's start to the end of its first batch's
    dispatch. The card has nothing of the pass to run until that
    dispatch's first launch; the launches after it, while the card runs
    the batch, are counted too."""
    if ctx["kind"] != "index":
        return None
    stage = ctx["window"]["stages"].get("index_fill")
    if not stage or stage["count"] <= 0:
        return None
    return 1e3 * stage["total_s"] / stage["count"]
