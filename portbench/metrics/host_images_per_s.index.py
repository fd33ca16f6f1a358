"""Per-layer metric ``host_images_per_s.index``: see ``read``."""

LAYER = "index pipeline"
UNIT = "images/s"
BETTER = "higher"
SOURCE = "host_clock"
MOVES = "index_card_images_per_s"


def read(ctx: dict):
    """Images indexed by whole ``POST /index`` passes over all the time
    from the window's first pass's start to its last one's end, on the
    client's clock: the rate a user of this host sees. Where the host's
    decode paces the passes it spreads with the host's load."""
    if ctx["kind"] != "index" or ctx["elapsed_s"] <= 0:
        return None
    return ctx["images"] / ctx["elapsed_s"]
