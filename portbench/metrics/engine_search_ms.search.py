"""Per-layer metric ``engine_search_ms.search``: see ``read``."""

LAYER = "engine and batchers"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "search_p95_ms"


def read(ctx: dict):
    """Mean time per request in the engine's ``search`` stage over the
    window: the wait in the fused text->search batcher and its dispatch
    (text tower, top-k, the copy back)."""
    if ctx["kind"] != "search":
        return None
    stage = ctx["window"]["stages"].get("search")
    if not stage or stage["count"] <= 0:
        return None
    return 1e3 * stage["total_s"] / stage["count"]
