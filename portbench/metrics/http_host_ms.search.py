"""Per-layer metric ``http_host_ms.search``: see ``read``."""

LAYER = "HTTP and thumbnails"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "search_p95_ms"


def read(ctx: dict):
    """Mean client latency of the window's requests (from due to last
    byte) less the mean time a request spent in the engine's ``search``
    stage: the time of the HTTP server, the request and JSON work and the
    thumbnails, and the client's own lateness."""
    if ctx["kind"] != "search":
        return None
    lat = [x for x in ctx["latencies_ms"] if x != float("inf")]
    stage = ctx["window"]["stages"].get("search")
    if not lat or not stage or stage["count"] <= 0:
        return None
    return sum(lat) / len(lat) - 1e3 * stage["total_s"] / stage["count"]
