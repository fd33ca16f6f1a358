"""Reduction of a ``torch.profiler`` Chrome trace to the numbers the
per-layer metrics read.

The split of device from host by event category and the idle share as
the union of device spans are copied from
``evossearch_tpu_torch/scripts/exp_merge_profile.py:trace_table``; the
window here is the profiler's own wall window as the harness timed it,
not the span from the first event to the last, so idle time before the
first kernel and after the last one counts.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

# Chrome-trace categories of what runs on the card
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# categories of host work that can name an idle gap
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
TOP = 10


def merge_spans(spans: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """The union of (start, end) spans as sorted disjoint spans."""
    merged: list[list[float]] = []
    for lo, hi in sorted(spans):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return [(lo, hi) for lo, hi in merged]


def _host_label(host: list[tuple[float, float, str]], starts: list[float],
                lo: float, hi: float) -> str:
    """The host op that overlaps the gap [lo, hi) the most, or
    ``no_torch_op`` when none does (Python, HTTP or JSON work)."""
    best, best_name = 0.0, "no_torch_op"
    i = max(bisect.bisect_left(starts, lo) - 64, 0)
    for s, e, name in host[i:]:
        if s >= hi:
            break
        overlap = min(e, hi) - max(s, lo)
        if overlap > best:
            best, best_name = overlap, name
    return best_name


def reduce_trace(events: list[dict], window_s: float) -> dict:
    """``busy_s`` (union of device spans), ``window_s``, ``device_ops``
    (seconds by op name, all of them), ``kernel_counts`` (launches by
    name), and ``idle_gaps``: the TOP longest gaps between device spans
    inside the traced events' extent, each named by the host op that
    overlapped it most."""
    dev, host = [], []
    ops: dict[str, float] = defaultdict(float)
    counts: dict[str, int] = defaultdict(int)
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        ts, dur = float(e["ts"]) * 1e-6, float(e["dur"]) * 1e-6
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur))
            ops[e["name"]] += dur
            counts[e["name"]] += 1
        elif cat in HOST_CATS:
            host.append((ts, ts + dur, e["name"]))
    merged = merge_spans(dev)
    busy = sum(hi - lo for lo, hi in merged)
    host.sort()
    starts = [h[0] for h in host]
    gaps = [(b[0] - a[1], a[1], b[0]) for a, b in zip(merged, merged[1:])]
    gaps.sort(reverse=True)
    idle = [[_host_label(host, starts, lo, hi), length]
            for length, lo, hi in gaps[:TOP]]
    return {
        "busy_s": busy,
        "window_s": window_s,
        "device_ops": dict(ops),
        "kernel_counts": dict(counts),
        "idle_gaps": idle,
    }


def top_ops(device_ops: dict[str, float]) -> list[list]:
    """The TOP device ops by time, as [name, seconds] pairs."""
    return [[n, s] for n, s in sorted(device_ops.items(), key=lambda x: -x[1])[:TOP]]
