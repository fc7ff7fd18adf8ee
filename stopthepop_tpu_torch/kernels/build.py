"""Build and load the port's native libraries (ctypes, built at first use).

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is compiled
with ``nvcc`` for ``sm_90a`` (Hopper) into ``build/torch_kernels/`` at the
root of the checkout, under a file name keyed by a hash of the source, the
shared headers ``csrc/*.cuh`` and the flags, and loaded with ``ctypes``. A
later process finds the library and skips the compile. Nothing here runs
at import time: the CPU tests import every module and have no ``nvcc``.

The host-side capture IO (``native/png_io.cpp``, ``native/ply_io.cpp`` in
this package) goes the same way through ``build_host``/``load_host``: the
host compiler (``g++``) into ``build/torch_native/``, named by a hash of the
source and its flags. A failed build raises with the compiler's log.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    # Each product and sum rounds on its own, as in the plain PyTorch
    # versions the kernels are held against.
    "-fmad=false",
    "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
]

NATIVE = Path(__file__).resolve().parent.parent / "native"
HOST_BUILD_DIR = BUILD_DIR.parent / "torch_native"
HOST_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
# What each host source links or needs beyond HOST_FLAGS (after the source,
# so that the linker keeps the library).
HOST_LIBS = {"png_io": ["-lz"], "ply_io": ["-pthread"]}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# name -> {"seconds": float, "ptxas": str}; empty for a library found built.
build_log: Dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are built at first use "
        "with the CUDA toolkit's nvcc (PATH or /usr/local/cuda/bin)."
    )


def _gxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError(
            "g++ not found: the port's PNG and PLY codecs are built at first "
            "use with the host compiler (PATH)."
        )
    return found


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is built. Its name hashes
    every header and the ``.cu`` sources it includes (a batched cascade's
    source includes its per-entry one) too, so an edited header rebuilds
    every kernel."""
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src)
    for included in re.findall(rb'#include "(\w+\.cu)"', src):
        h.update((CSRC / included.decode()).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def host_library_path(name: str) -> Path:
    """Where the library of ``native/<name>.cpp`` is built, named by a hash
    of the source and its flags."""
    h = hashlib.sha256((NATIVE / f"{name}.cpp").read_bytes())
    h.update(" ".join(HOST_FLAGS + HOST_LIBS[name]).encode())
    return HOST_BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(out: Path, cmd: List[str], src: Path, libs: Sequence[str] = ()):
    """Start ``cmd -o <tmp> src libs`` for one source; returns (process,
    tmp path, out path, source, t0) or None when ``out`` is already built."""
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.Popen([*cmd, "-o", str(tmp), str(src), *libs],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out, src, time.perf_counter()


def _finish(started) -> dict:
    """Wait for a started compile, move its library into place and return
    {"seconds", "log"}; raises RuntimeError with the compiler's log."""
    proc, tmp, out, src, t0 = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"{proc.args[0]} failed for {src.name}:\n{log}")
    os.replace(tmp, out)
    return {"seconds": time.perf_counter() - t0, "log": log}


def build(names: List[str]) -> None:
    """Compile every named source that is not built yet, all in parallel."""
    with _lock:
        started = {n: _start(library_path(n), [_nvcc(), *NVCC_FLAGS],
                             CSRC / f"{n}.cu") for n in names}
        for n, s in started.items():
            if s is not None:
                done = _finish(s)
                build_log[n] = {"seconds": done["seconds"], "ptxas": done["log"]}


def build_host(names: List[str]) -> None:
    """Compile every named ``native/<name>.cpp`` that is not built yet with
    the host compiler, all in parallel."""
    with _lock:
        started = [_start(host_library_path(n), [_gxx(), *HOST_FLAGS],
                          NATIVE / f"{n}.cpp", HOST_LIBS[n]) for n in names]
        for s in started:
            if s is not None:
                _finish(s)


def all_sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def load(name: str) -> ctypes.CDLL:
    """The ctypes library of ``csrc/<name>.cu``, built at first use."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _libs[name] = lib
    return lib


def load_host(name: str) -> ctypes.CDLL:
    """The ctypes library of ``native/<name>.cpp``, built at first use.
    ``ctypes.CDLL`` releases the GIL for the length of each call."""
    build_host([name])
    return ctypes.CDLL(str(host_library_path(name)))
