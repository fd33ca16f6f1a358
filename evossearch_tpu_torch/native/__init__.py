"""Build and load the package's native host extension at first use.

``evossearch_native.cpp`` (the threaded exact host scanner and the libjpeg
decoders) compiles with ``g++`` into ``evossearch_tpu_torch/_build/``
(git-ignored), named by a hash of the source, the command and the CPU that
``-march=native`` resolves to, so an edited source rebuilds and an
unchanged one loads straight away. Without the libjpeg headers it builds
with ``-DEVS_NO_JPEG``: the scanner alone. Several processes may build at
once (test workers): a file lock serializes them, and each compiles to a
private name that ``os.replace`` publishes. Nothing here runs at import
time.
"""

from __future__ import annotations

import fcntl
import hashlib
import importlib.machinery
import importlib.util
import os
import subprocess
import sys
import sysconfig
import time
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "evossearch_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
# the init symbol is PyInit__native, whatever the file is called
MODULE_NAME = "evossearch_tpu_torch._native"
COMPILER = "g++"


def probe() -> tuple[bool, str]:
    """(whether ``jpeglib.h`` is found, the target flags ``-march=native``
    expands to) from one preprocessor run."""
    proc = subprocess.run(
        [COMPILER, "-march=native", "-E", "-v", "-x", "c++", "-o", os.devnull, "-"],
        input="#include <cstdio>\n#include <jpeglib.h>\n",
        capture_output=True, text=True, timeout=60,
    )
    target = next(
        (line for line in proc.stderr.splitlines() if "cc1plus" in line), ""
    )
    # the cc1plus line also names files; keep its flags and values
    flags = " ".join(w for w in target.split() if "/" not in w)
    return proc.returncode == 0, flags


def command(jpeg: bool, out: Path) -> list[str]:
    """The g++ command line (the flags of the JAX package's build
    script), without libjpeg when its headers are missing."""
    cmd = [COMPILER, "-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
           f"-I{sysconfig.get_paths()['include']}"]
    if not jpeg:
        cmd.append("-DEVS_NO_JPEG")
    cmd.append(str(SOURCE))
    if jpeg:
        cmd.append("-ljpeg")
    return cmd + ["-lpthread", "-o", str(out)]


def library_path(jpeg: bool, target: str) -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(command(jpeg, Path("OUT"))).encode())
    h.update(target.encode())
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return BUILD_DIR / f"_native_{h.hexdigest()[:16]}{suffix}"


def build(compile: bool = True) -> dict:
    """Build the library unless it exists. Returns what happened:
    ``jpeglib_h``, ``library`` (its path, or None when it is missing and
    ``compile`` is false), ``command`` and ``seconds`` (both None when no
    compile ran in this call). Raises RuntimeError when g++ fails."""
    jpeg, target = probe()
    out = library_path(jpeg, target)
    info = {"jpeglib_h": jpeg, "library": out, "command": None, "seconds": None}
    if out.exists():
        return info
    if not compile:
        return dict(info, library=None)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if out.exists():  # another process built it while this one waited
            return info
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = command(jpeg, tmp)
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
            if proc.returncode:
                raise RuntimeError(
                    f"g++ failed for {SOURCE.name}:\n{proc.stderr[-4000:]}"
                )
            os.replace(tmp, out)
        finally:
            tmp.unlink(missing_ok=True)
    return dict(info, command=command(jpeg, out), seconds=time.perf_counter() - t0)


def load(path: Path):
    """The extension at ``path`` as module ``evossearch_tpu_torch._native``."""
    loader = importlib.machinery.ExtensionFileLoader(MODULE_NAME, str(path))
    spec = importlib.util.spec_from_file_location(MODULE_NAME, path, loader=loader)
    mod = importlib.util.module_from_spec(spec)
    loader.exec_module(mod)
    sys.modules[MODULE_NAME] = mod
    return mod
