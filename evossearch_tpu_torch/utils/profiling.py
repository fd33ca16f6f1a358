"""Profiling hooks: ``capture_trace`` wraps ``torch.profiler`` and writes a
Chrome-trace JSON per capture (CPU and, on a GPU, CUDA activity).

Off unless EVOSSEARCH_PROFILE_DIR is set (each capture lands as a
timestamped file under that directory) or a directory is passed. It is
wired into the hot routes (/search, /search_by_image, /index —
server/app.py); ``StageTimer`` regions double as ``record_function``
spans while profiling is on, so the stages are visible on the timeline.
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager

_active = threading.Lock()  # one active profiler per process


def enabled() -> bool:
    """Whether trace capture is configured for this process."""
    return bool(os.environ.get("EVOSSEARCH_PROFILE_DIR"))


@contextmanager
def capture_trace(log_dir: str | None = None):
    """torch.profiler trace around a block; no-op when no directory is
    set. A request landing while another is traced proceeds untraced."""
    log_dir = log_dir or os.environ.get("EVOSSEARCH_PROFILE_DIR")
    if not log_dir or not _active.acquire(blocking=False):
        yield
        return
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            yield
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{time.time_ns()}.json")
        )
    finally:
        _active.release()


@contextmanager
def annotate(name: str):
    """Named region visible in profiler timelines."""
    from torch.profiler import record_function

    with record_function(name):
        yield
