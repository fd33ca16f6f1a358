"""Per-layer metric ``card_wait_ms_per_image.index``: see ``read``."""

LAYER = "model step"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "index_card_images_per_s"


def read(ctx: dict):
    """Time the indexing pipeline's consumer spent blocked on the card per
    image indexed over the window: its ``encode_upload`` stage (the
    pageable copies of canvases and indices, which first wait for the work
    the stream holds) and its ``prep_encode_fetch`` stage (the embeddings'
    copy back). The tower's launches (``encode_dispatch``), which block
    only while the launch queue is full, are not counted."""
    if ctx["kind"] != "index" or ctx["images"] <= 0:
        return None
    stages = ctx["window"]["stages"]
    upload, fetch = stages.get("encode_upload"), stages.get("prep_encode_fetch")
    if not upload or not fetch:
        return None
    return 1e3 * (upload["total_s"] + fetch["total_s"]) / ctx["images"]
