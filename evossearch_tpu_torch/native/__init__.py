"""Build and load the package's native host extension at first use.

``evossearch_native.cpp`` (the threaded exact host scanner and the libjpeg
decoders) compiles with ``g++`` into ``evossearch_tpu_torch/_build/``
(git-ignored), named by a hash of the source, the command and the CPU that
``-march=native`` resolves to, so an edited source rebuilds and an
unchanged one loads straight away. The decoders link libjpeg by one of
three routes, the first that the machine allows:

  ``system``   the system's ``jpeglib.h``, linked with ``-ljpeg``;
  ``pillow``   the libjpeg-turbo 62-ABI headers carried in ``include/``
               beside this file (with their license), linked by full path
               to the ``libjpeg-*.so.62*`` that Pillow's wheel bundles in
               ``pillow.libs/``, with an rpath to that directory;
  ``none``     ``-DEVS_NO_JPEG``: the scanner alone, images decode with
               Pillow.

The path of Pillow's library is part of the command, so it enters the
hash. Several processes may build at once (test workers): a file lock
serializes them, and each compiles to a private name that ``os.replace``
publishes. Nothing here runs at import time.
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
INCLUDE_DIR = Path(__file__).resolve().parent / "include"


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


def pillow_libjpeg() -> Path | None:
    """The libjpeg (62 ABI) that the installed Pillow wheel bundles, found
    beside the ``PIL`` package without importing it; None when Pillow is
    missing or links a system libjpeg."""
    spec = importlib.util.find_spec("PIL")
    if spec is None or not spec.submodule_search_locations:
        return None
    libs = Path(next(iter(spec.submodule_search_locations))).parent / "pillow.libs"
    return next(iter(sorted(libs.glob("libjpeg-*.so.62*"))), None)


def route_of(jpeglib_h: bool, pillow_lib: Path | None) -> str:
    """The first route the machine allows: ``system``, ``pillow``,
    ``none``."""
    if jpeglib_h:
        return "system"
    return "pillow" if pillow_lib is not None else "none"


def command(route: str, out: Path, pillow_lib: Path | None = None) -> list[str]:
    """The g++ command line of ``route`` (the flags of the JAX package's
    build script): ``-ljpeg``, the carried headers and Pillow's library
    by path, or no libjpeg at all."""
    cmd = [COMPILER, "-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
           f"-I{sysconfig.get_paths()['include']}"]
    if route == "pillow":
        cmd.append(f"-I{INCLUDE_DIR}")
    elif route == "none":
        cmd.append("-DEVS_NO_JPEG")
    cmd.append(str(SOURCE))
    if route == "system":
        cmd.append("-ljpeg")
    elif route == "pillow":
        # by path, never -ljpeg: the bundled file's soname is renamed
        cmd += [str(pillow_lib), f"-Wl,-rpath,{pillow_lib.parent}"]
    return cmd + ["-lpthread", "-o", str(out)]


def library_path(route: str, target: str, pillow_lib: Path | None = None) -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(command(route, Path("OUT"), pillow_lib)).encode())
    h.update(target.encode())
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return BUILD_DIR / f"_native_{h.hexdigest()[:16]}{suffix}"


def build(compile: bool = True) -> dict:
    """Build the library unless it exists. Returns what happened:
    ``route`` (``system``, ``pillow`` or ``none``), ``jpeglib_h`` (the system headers
    found), ``pillow_libjpeg`` (Pillow's library, or None), ``library``
    (its path, or None when it is missing and ``compile`` is false),
    ``command`` and ``seconds`` (both None when no compile ran in this
    call). Raises RuntimeError when g++ fails."""
    jpeg, target = probe()
    pillow_lib = pillow_libjpeg()
    route = route_of(jpeg, pillow_lib)
    lib = pillow_lib if route == "pillow" else None
    out = library_path(route, target, lib)
    info = {"route": route, "jpeglib_h": jpeg,
            "pillow_libjpeg": None if pillow_lib is None else str(pillow_lib),
            "library": out, "command": None, "seconds": None}
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
        cmd = command(route, tmp, lib)
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
    return dict(info, command=command(route, out, lib),
                seconds=time.perf_counter() - t0)


def load(path: Path):
    """The extension at ``path`` as module ``evossearch_tpu_torch._native``."""
    loader = importlib.machinery.ExtensionFileLoader(MODULE_NAME, str(path))
    spec = importlib.util.spec_from_file_location(MODULE_NAME, path, loader=loader)
    mod = importlib.util.module_from_spec(spec)
    loader.exec_module(mod)
    sys.modules[MODULE_NAME] = mod
    return mod
