"""Per-layer metric ``decode_ms_per_image.index``: see ``read``."""

LAYER = "index pipeline"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "index_card_images_per_s"


def read(ctx: dict):
    """Busy time of the index builder's producer thread in its
    ``index_decode`` stage (reading and decoding the JPEGs) per image
    indexed over the window."""
    if ctx["kind"] != "index" or ctx["images"] <= 0:
        return None
    stage = ctx["window"]["stages"].get("index_decode")
    if not stage:
        return None
    return 1e3 * stage["total_s"] / ctx["images"]
