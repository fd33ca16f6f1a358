"""Per-layer metric ``search_mfu``: see ``read``."""

from portbench import flops

LAYER = "model step"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "search_p95_ms"


def read(ctx: dict):
    """The FLOPs that the queries completed in the traced sub-window need
    (the text tower at every context position, and the exact scan of the
    library: 2 N d per query; padding rows not counted) over the card's
    busy time in the sub-window at the bf16 peak. The offered rate is
    fixed, so the busy time and not the window is the divisor."""
    trace = ctx.get("trace")
    if ctx["kind"] != "search" or not trace or trace["busy_s"] <= 0:
        return None
    queries = trace["delta"]["counters"].get("queries", 0)
    if queries <= 0:
        return None
    per_query = flops.text_fwd_flops(ctx["model"]) + flops.scan_flops(ctx["rows"], ctx["dim"])
    return 100.0 * queries * per_query / (trace["busy_s"] * flops.PEAK_BF16_FLOPS)
