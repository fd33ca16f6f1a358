"""Build and load the port's CUDA kernels at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``)
into its own shared library with a plain C entry point, loaded through
``ctypes`` — no PyTorch headers, so a build takes seconds. Libraries land
in ``evossearch_tpu_torch/_build/`` (git-ignored), named by a hash of
their sources and flags, so an edited source rebuilds and an unchanged one
loads straight away. All missing kernels compile at once, one ``nvcc``
process each. Nothing here runs at import time: the CPU tests import
every module on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
KERNELS = ("topk_block", "topk_tree", "topk_sq8", "topk_stream")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# entry point -> (library, C symbol, C signature) (see the .cu files)
_SIGNATURES = {
    "topk_block": ("topk_block", "evs_topk_block",
                   [_P, _I, _P, _I, _I, _I, _I, _I, _P, _P, _P]),
    "topk_tree": ("topk_tree", "evs_topk_tree",
                  [_P, _I, _P, _I, _I, _I, _I, _P, _P, _P, _P]),
    "topk_sq8": ("topk_sq8", "evs_topk_sq8",
                 [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P]),
    "topk_sq8_variant": ("topk_sq8", "evs_topk_sq8_variant",
                         [_I, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P]),
    "topk_stream": ("topk_stream", "evs_topk_stream",
                    [_P, _I, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P]),
}

_lock = threading.Lock()
_loaded: dict[str, object] = {}
# name -> {"seconds": wall time of the build that produced it, "log": nvcc
# output (ptxas register/spill report)}; filled only by builds this process ran
BUILD_LOG: dict[str, dict] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(home) / "bin" / "nvcc"] if home else []) + [
        Path("/usr/local/cuda/bin/nvcc")
    ]:
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}_{h.hexdigest()[:16]}.so"


def build(names=KERNELS) -> dict[str, Path]:
    """Compile every named kernel whose library is missing, all ``nvcc``
    processes started together. Returns name -> library path."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        started = {}
        t0 = time.perf_counter()
        try:
            for name in names:
                out = library_path(name)
                if out.exists():
                    continue
                tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp")
                cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
                proc = subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True,
                )
                started[name] = (proc, tmp, out)
            for name, (proc, tmp, out) in started.items():
                log, _ = proc.communicate()
                if proc.returncode:
                    raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
                os.replace(tmp, out)
                BUILD_LOG[name] = {
                    "seconds": time.perf_counter() - t0, "log": log,
                }
        finally:
            for proc, tmp, _ in started.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                tmp.unlink(missing_ok=True)
    return {name: library_path(name) for name in names}


def entry(name: str):
    """The C entry point ``name`` (a key of ``_SIGNATURES``), building its
    library if needed."""
    fn = _loaded.get(name)
    if fn is not None:
        return fn
    lib, symbol, argtypes = _SIGNATURES[name]
    path = build((lib,))[lib]
    with _lock:
        fn = _loaded.get(name)
        if fn is None:
            fn = getattr(ctypes.CDLL(str(path)), symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _loaded[name] = fn
    return fn
