"""Per-layer metric ``topk_roofline.search``: see ``read``."""

from portbench import flops

LAYER = "kernels"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "search_p95_ms"

# The top-k scan's kernels as the trace names them: B1, the tensor-core
# tree kernel on bfloat16 rows (ops/csrc/topk_tc.cuh). A kernel that
# replaces it is added here by a benchmark change; until then this metric
# reads nothing.
KERNELS = ("tc_kernel<unsigned short, evs::tc::RawDot",)


def read(ctx: dict):
    """The least time the scans of the traced sub-window need (each
    launch reads the library's bf16 rows once; the queries read and the
    results written once) at the card's bandwidth, over the device time
    of the kernels named in KERNELS."""
    trace = ctx.get("trace")
    if ctx["kind"] != "search" or not trace:
        return None
    ops = [n for n in trace["device_ops"] if any(k in n for k in KERNELS)]
    launches = sum(trace["kernel_counts"][n] for n in ops)
    spent = sum(trace["device_ops"][n] for n in ops)
    if launches <= 0 or spent <= 0:
        return None
    queries = trace["delta"]["counters"].get("queries", 0)
    mean_k = sum(ctx["limits"]) / len(ctx["limits"])
    need = launches * flops.scan_bytes(ctx["rows"], ctx["dim"], 0, 0) + flops.scan_bytes(
        0, ctx["dim"], queries, mean_k)
    return 100.0 * need / flops.PEAK_HBM_BYTES_PER_S / spent
