"""Profiling hooks: ``capture_trace`` wraps ``torch.profiler`` and writes a
Chrome-trace JSON per capture (CPU and, on a GPU, CUDA activity, of every
thread of the process).

Off unless EVOSSEARCH_PROFILE_DIR is set (each capture lands as a
timestamped file under that directory) or a directory is passed. It is
wired into the hot routes (/search, /search_by_image, /index —
server/app.py). Whoever starts the profiler, ``StageTimer`` stages become
``record_function`` spans while it records (``recording()``), so the
stages lie on the timeline beside the kernels they launch; stages that
enclose others stay off it (``StageTimer.stage``).
"""

from __future__ import annotations

import os
import sys
import threading
import time
from contextlib import contextmanager

_active = threading.Lock()  # one active profiler per process


def recording() -> bool:
    """Whether a ``torch.profiler`` (or ``torch.autograd.profiler``)
    profiler is recording in this process, whichever thread started it:
    the flag torch sets when a profiler starts and clears when it stops.
    False while torch's profiler module is not loaded, as none can be."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and getattr(prof, "_is_profiler_enabled", False)


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
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        # every thread: the index producer and the batchers' workers run
        # the request's work outside the thread that opened the capture
        with profile(activities=activities, experimental_config=_ExperimentalConfig(
                profile_all_threads=True)) as prof:
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
