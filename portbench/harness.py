"""What every traffic kind shares: the run's context, the program's engine
and HTTP server set up from a configuration, snapshots of the program's
counters, the client process, the traced sub-window and the statistics.

Nothing here imports ``torch`` or the program at module level; ``run.py``
checks for the card first.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

from portbench.data import family

ROOT = Path(__file__).resolve().parent


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``; 0 elsewhere)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


@dataclasses.dataclass
class Run:
    """One run of one cell."""

    workload: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    tmp: Path
    started: float  # time.monotonic() of the process's start
    # what a test swaps in for the timed path (see tests/): called with
    # the engine before the window opens
    tamper: object = None

    @property
    def model(self) -> dict:
        return self.config["model"]


# -- the program ------------------------------------------------------------


def model_spec(model: dict):
    """The program's spec for a configuration's ``model`` block: a
    CLIPModelSpec, or a CLIPResNetSpec for the ``resnet`` family, from the
    fields of that class."""
    from evossearch_tpu_torch.core.constants import CLIPModelSpec, CLIPResNetSpec

    cls = CLIPResNetSpec if family(model) == "resnet" else CLIPModelSpec
    return cls(**{f.name: model[f.name] for f in dataclasses.fields(cls)})


def engine_config(config: dict):
    """The program's Config with the configuration's ``engine`` settings
    (environment and ``.env`` files ignored)."""
    from evossearch_tpu_torch.core import Config

    cfg = Config(env_path=None)
    for key, value in config["engine"].items():
        setattr(cfg, key, value)
    return cfg


def build_engine(run: Run, weights: dict):
    """The program's SearchEngine on the seeded weights. The program's log
    (a line per request at its default level) goes to a file of the run,
    as a served deployment's would, so that its cost does not depend on
    who reads this process's standard error."""
    import logging

    import torch

    from evossearch_tpu_torch.engine import SearchEngine
    from evossearch_tpu_torch.models import CLIP

    from evossearch_tpu_torch.utils import get_logger

    get_logger("server")  # installs the program's handler, which is replaced here
    root = logging.getLogger("evossearch")
    for h in list(root.handlers):
        root.removeHandler(h)
    handler = logging.FileHandler(run.tmp / "program.log")
    handler.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s"))
    root.addHandler(handler)
    spec = model_spec(run.model)
    with torch.device(run.device):
        module = CLIP(spec)
    module.load_state_dict(weights, strict=True)
    module.eval()
    return SearchEngine(cfg=engine_config(run.config), spec=spec, params=module,
                        device=run.device)


class Server:
    """The program's HTTP app on its own threaded WSGI server
    (``server.web``'s server and handler classes, as ``web.serve`` builds
    them) at an ephemeral port of 127.0.0.1, stoppable."""

    def __init__(self, engine, cfg):
        from wsgiref.simple_server import make_server

        from evossearch_tpu_torch.server import create_app
        from evossearch_tpu_torch.server import web

        self.app = create_app(engine=engine, cfg=cfg)
        self.httpd = make_server("127.0.0.1", 0, self.app,
                                 server_class=web._ThreadingWSGIServer,
                                 handler_class=web._QuietHandler)
        self.port = self.httpd.server_address[1]
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=10)
        self.app = None


def settle() -> None:
    """End of set-up: write the set-up's files out to disk now, so that the
    kernel's writeback of them does not fall into the window."""
    os.sync()


def post(port: int, path: str, body: dict, timeout: float = 600.0) -> tuple[int, dict]:
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", path, json.dumps(body), {"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
    finally:
        conn.close()
    try:
        return resp.status, json.loads(data)
    except ValueError:
        return resp.status, {}


def snapshot(engine) -> dict:
    """The program's counters, stage totals and the fused batcher's
    dispatch counts at one moment."""
    fused = engine.__dict__.get("_fused_batcher_inst")
    return {
        "counters": engine.counters.snapshot(),
        "stages": {k: {"total_s": v["total_s"], "count": v["count"]}
                   for k, v in engine.timers.snapshot().items()},
        "fused": {"dispatches": getattr(fused, "dispatches", 0),
                  "batched_queries": getattr(fused, "batched_queries", 0)},
    }


def delta(a: dict, b: dict) -> dict:
    """b - a of two snapshots."""
    stages = {k: {"total_s": v["total_s"] - a["stages"].get(k, {}).get("total_s", 0.0),
                  "count": v["count"] - a["stages"].get(k, {}).get("count", 0)}
              for k, v in b["stages"].items()}
    return {
        "counters": {k: v - a["counters"].get(k, 0.0) for k, v in b["counters"].items()},
        "stages": stages,
        "fused": {k: v - a["fused"][k] for k, v in b["fused"].items()},
    }


# -- the client and the traced sub-window ----------------------------------


def start_client(spec: dict, tmp: Path) -> tuple[subprocess.Popen, Path]:
    spec_path, out_path = tmp / "client_spec.json", tmp / "client_out.json"
    spec_path.write_text(json.dumps(spec))
    env = dict(os.environ, PYTHONPATH=str(ROOT.parent))
    proc = subprocess.Popen([sys.executable, "-m", "portbench.client", str(spec_path),
                             str(out_path)], env=env, cwd=str(ROOT.parent))
    return proc, out_path


def finish_client(proc: subprocess.Popen, out_path: Path, timeout: float) -> dict:
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise RuntimeError("the client did not finish in time")
    if rc != 0:
        raise RuntimeError(f"the client exited with {rc}")
    return json.loads(out_path.read_text())


def _profile(torch, host: bool = True):
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    # every thread, also those started before the profiler (the program's
    # batcher threads); without it their ops and kernels go unrecorded
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host else [
        ProfilerActivity.CUDA]
    return profile(activities=activities,
                   experimental_config=_ExperimentalConfig(profile_all_threads=True))


def warm_profiler(host: bool = True) -> None:
    """Start and stop the profiler once in set-up: its first start loads
    and sets up CUPTI, which takes seconds that would otherwise fall into
    the traced window."""
    import torch

    with _profile(torch, host):
        if torch.cuda.is_available():
            torch.ones(8, device="cuda").sum().item()


def start_card_trace():
    """A ``torch.profiler`` of the card's activity alone (kernels, copies,
    memsets; no host ops), started now; ``card_busy_s`` stops it."""
    import torch

    prof = _profile(torch, host=False)
    prof.start()
    return prof


def card_busy_s(run: Run, prof) -> float:
    """Stops ``start_card_trace``'s profiler once the card has finished
    what it was given, and returns the seconds in which an operation ran
    on the card meanwhile (the union of device spans, ``trace.reduce_trace``)."""
    import torch

    from portbench import trace

    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    path = run.tmp / "card_trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text()).get("traceEvents", [])
    path.unlink()
    reduced = trace.reduce_trace(events, 0.0)
    copies = sum(t for name, t in reduced["device_ops"].items() if name.startswith("Memcpy"))
    log(f"card trace: busy {reduced['busy_s']:.4f} s, of which copies take {copies:.4f} s")
    return reduced["busy_s"]


def traced_subwindow(engine, t0: float, offset: float, length: float) -> dict:
    """``torch.profiler`` (CPU and CUDA activity) over ``length`` seconds
    from ``t0 + offset``, with the program's counters around it. Returns
    the profiler and its wall window; ``reduce_subwindow`` reads them once
    the window has closed, so that the reading does not load the server
    during the window."""
    import torch

    wait = t0 + offset - time.monotonic()
    if wait > 0:
        time.sleep(wait)
    before = snapshot(engine)
    with _profile(torch) as prof:
        w0 = time.monotonic()
        time.sleep(length)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        w1 = time.monotonic()
    return {"prof": prof, "window_s": w1 - w0, "delta": delta(before, snapshot(engine))}


def reduce_subwindow(run: Run, traced: dict | None) -> dict | None:
    """The traced sub-window reduced by ``trace.reduce_trace`` over the
    profiler's own wall window, with the counters' change across it."""
    from portbench import trace

    if traced is None:
        return None
    path = run.tmp / "trace.json"
    traced["prof"].export_chrome_trace(str(path))
    events = json.loads(path.read_text()).get("traceEvents", [])
    path.unlink()
    reduced = trace.reduce_trace(events, traced["window_s"])
    reduced["delta"] = traced["delta"]
    return reduced


# -- statistics -------------------------------------------------------------


def percentile(values: list[float], q: float) -> float:
    """The q-quantile (0..1) by linear interpolation between order
    statistics; an infinite value (a failed request) sorts last."""
    v = sorted(values)
    if not v:
        return math.nan
    pos = q * (len(v) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(v) - 1)
    if v[hi] == math.inf:
        return math.inf if pos > lo or v[lo] == math.inf else v[lo]
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


# -- the result -------------------------------------------------------------

FORBIDDEN = ("jax", "jaxlib", "flax", "evossearch_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's (``evossearch_tpu_torch`` is not ``evossearch_tpu``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def card() -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"
