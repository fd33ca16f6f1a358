"""Per-layer metric ``queries_per_dispatch.search``: see ``read``."""

LAYER = "engine and batchers"
UNIT = "queries"
BETTER = "higher"
SOURCE = "program_counter"
MOVES = "search_p95_ms"


def read(ctx: dict):
    """Queries the fused text->search batcher carried per dispatch over
    the window."""
    if ctx["kind"] != "search":
        return None
    fused = ctx["window"]["fused"]
    if fused["dispatches"] <= 0:
        return None
    return fused["batched_queries"] / fused["dispatches"]
