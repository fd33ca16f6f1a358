"""Per-layer metric ``feed_wait_ms_per_image.index``: see ``read``."""

LAYER = "index pipeline"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "index_card_images_per_s"


def read(ctx: dict):
    """Time the indexing pipeline's consumer spent waiting on the producer's
    queue after each pass's first batch (``index_feed_wait``: the steady
    state paced by the host's decode) per image indexed over the window."""
    if ctx["kind"] != "index" or ctx["images"] <= 0:
        return None
    stage = ctx["window"]["stages"].get("index_feed_wait")
    if not stage:
        return None
    return 1e3 * stage["total_s"] / ctx["images"]
