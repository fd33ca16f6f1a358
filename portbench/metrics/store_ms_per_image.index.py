"""Per-layer metric ``store_ms_per_image.index``: see ``read``."""

LAYER = "index store"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "index_card_images_per_s"


def read(ctx: dict):
    """Time the indexing pipeline's consumer spent in the shard store per
    image indexed over the window: its ``index_write`` stage (the
    appends) and its ``index_finalize`` stage (the manifest, metadata and
    the atomic publish)."""
    if ctx["kind"] != "index" or ctx["images"] <= 0:
        return None
    stages = ctx["window"]["stages"]
    write, finalize = stages.get("index_write"), stages.get("index_finalize")
    if not write or not finalize:
        return None
    return 1e3 * (write["total_s"] + finalize["total_s"]) / ctx["images"]
