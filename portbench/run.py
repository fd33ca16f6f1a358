"""Run one cell of the benchmark once:

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is ``workloads/<cell>.json``; it names a configuration
(``configs/<config>.json``) and a traffic mix (``traffic/<traffic>.json``),
whose ``kind`` names the generator ``traffic/<kind>.py``. With
``--trace 0`` the last line of standard output holds the end-to-end
metrics the generator measured (on the host clock, or from a trace of the
card's activity) and ``setup_s``; with
``--trace 1`` it holds every per-layer metric (``metrics/<metric>.py``)
whose reader finds something to read in this cell. Either way the
outputs of the timed path are checked against the reference after the
window, and each number compared is printed beside its limit, last on
standard error and last in the result.

Exits non-zero, printing no result, without a CUDA device (or with fewer
than the cell asks for), when the program cannot be imported, or when
JAX or the JAX package was loaded in this process.
"""

from __future__ import annotations

import time

from portbench.harness import process_age_s

STARTED = time.monotonic() - process_age_s()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

from portbench import harness  # noqa: E402
from portbench.harness import ROOT, log  # noqa: E402


def load_json(root: Path, kind: str, name: str) -> dict:
    path = root / kind / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"portbench: no {kind} file {path}")
    return json.loads(path.read_text())


def load_cell(name: str, root: Path = ROOT) -> tuple[dict, dict, dict]:
    """The cell's file, its configuration and its traffic mix, found by
    name under ``root``."""
    workload = load_json(root, "workloads", name)
    return (workload, load_json(root, "configs", workload["config"]),
            load_json(root, "traffic", workload["traffic"]))


def _load_module(path: Path, prefix: str):
    spec = importlib.util.spec_from_file_location(prefix + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def traffic_kind(traffic: dict, root: Path = ROOT):
    """The generator ``traffic/<kind>.py`` of a traffic mix."""
    return _load_module(root / "traffic" / f"{traffic['kind']}.py", "portbench_kind_")


def metric_readers(root: Path = ROOT) -> dict:
    """Every per-layer metric's reader under ``root``, by name (the file
    name without ``.py``)."""
    return {path.stem: _load_module(path, "portbench_metric_")
            for path in sorted((root / "metrics").glob("*.py"))
            if not path.name.startswith("_")}


def per_layer(ctx: dict, reported: set, root: Path = ROOT) -> dict:
    """The per-layer metrics of a traced run: each reader whose end-to-end
    metric this cell reports and that finds something to read."""
    out = {}
    for name, mod in metric_readers(root).items():
        if mod.MOVES not in reported:
            continue
        value = mod.read(ctx)
        if value is not None:
            out[name] = {"value": value, "unit": mod.UNIT}
    return out


def judge(compared: dict, limits: dict, problems: list[str]) -> tuple[bool, dict]:
    """Whether the check passed, and each number beside its limit."""
    shown = {k: {"value": v, "limit": limits[k]} for k, v in compared.items()}
    ok = not problems and all(v <= limits[k] and not math.isnan(v) for k, v in compared.items())
    return ok, shown


def execute(run: harness.Run, kind, root: Path = ROOT) -> dict:
    """One run of a cell through its traffic kind, as the result line's
    fields."""
    result = kind.run(run)
    ok, shown = judge(result["compared"], run.workload["limits"], result["problems"])
    if run.trace:
        ctx = dict(result["ctx"], config=run.config)
        metrics = per_layer(ctx, set(result["e2e"]) | {"setup_s"}, root)
    else:
        metrics = {k: {"value": v, "unit": run.workload["units"][k]}
                   for k, v in result["e2e"].items() if v is not None}
        metrics["setup_s"] = {"value": result["t0"] - run.started, "unit": "s"}
    out = {"correct": ok, "attempted": result["attempted"], "failed": result["failed"],
           "metrics": metrics, "device": dict(result["card"])}
    traced = result["ctx"].get("trace")
    if run.trace and traced is not None:
        from portbench.trace import top_ops

        out["device"]["busy_s"] = traced["busy_s"]
        out["device"]["window_s"] = traced["window_s"]
        out["breakdown"] = {"device_ops": top_ops(traced["device_ops"]),
                            "idle_gaps": traced["idle_gaps"]}
    for p in result["problems"][:20]:
        log(f"check failed: {p}")
    out["compared"] = shown
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    workload, config, traffic = load_cell(args.workload)

    for key in [k for k in os.environ if k.startswith("EVOSSEARCH_")]:
        del os.environ[key]  # the cell's files alone configure the program
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_TF", "0")
    cache = ROOT.parent / ".portbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < workload["chips"]:
        log(f"needs {workload['chips']} CUDA device(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    import evossearch_tpu_torch  # noqa: F401  (the program under test)

    log(f"cell {args.workload} seed {args.seed} seconds {args.seconds} trace {args.trace}; "
        f"card {harness.power_limit()}; torch {torch.__version__}")
    tmp = Path(tempfile.mkdtemp(prefix="portbench_"))
    try:
        run = harness.Run(workload=workload, config=config, traffic=traffic, seed=args.seed,
                          seconds=args.seconds, trace=bool(args.trace), device="cuda:0",
                          tmp=tmp, started=STARTED)
        out = execute(run, traffic_kind(traffic))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    bad = harness.forbidden_modules()
    if bad:
        log(f"JAX or the JAX package was loaded in this process: {', '.join(bad)}")
        return 3
    for k, v in out["compared"].items():
        log(f"compared {k} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
