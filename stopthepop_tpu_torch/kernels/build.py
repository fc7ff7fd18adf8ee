"""Build and load the port's CUDA kernels (nvcc into a ctypes library).

Each ``csrc/<name>.cu`` has a plain C interface. At first use it is compiled
with ``nvcc`` for ``sm_90a`` (Hopper) into ``build/torch_kernels/`` at the
root of the checkout, under a file name keyed by a hash of the source, the
shared headers ``csrc/*.cuh`` and the flags, and loaded with ``ctypes``. A
later process finds the library and skips the compile. Nothing here runs
at import time: the CPU tests import every module and have no ``nvcc``.
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
from typing import Dict, List

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


def _start(name: str):
    """Start nvcc for one source; returns (process, tmp path, out path, t0)
    or None when the library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, time.perf_counter()


def _finish(name: str, started) -> None:
    proc, tmp, out, t0 = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)
    build_log[name] = {"seconds": time.perf_counter() - t0, "ptxas": log}


def build(names: List[str]) -> None:
    """Compile every named source that is not built yet, all in parallel."""
    with _lock:
        started = {n: _start(n) for n in names}
        for n, s in started.items():
            if s is not None:
                _finish(n, s)


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
