"""Tests of the benchmark harness, on the CPU at tiny sizes; those marked
``card`` need a CUDA device and skip without one."""

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

# The tiny stand-in of every configuration: its scene and image sizes.
TINY = {"gaussians": 3000, "width": 70, "height": 45}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def copy_root(dest: Path, tiny: bool = True) -> Path:
    """A checkout-like root at ``dest``: BENCHMARK.json and portbench/,
    every configuration cut to ``TINY`` where ``tiny``."""
    shutil.copytree(BENCH, dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    if tiny:
        for c in bench["configs"]:
            path = dest / c["file"]
            cfg = json.loads(path.read_text())
            cfg.update(TINY)
            path.write_text(json.dumps(cfg))
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    return copy_root(tmp_path)


def run_cell(root, workload, seed=2_900_000_001, seconds=0.3, trace=0):
    """One CPU run of ``workload`` under ``root``: (rc, result dict)."""
    import contextlib
    import io
    import time

    from harness.runner import main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(["--workload", workload, "--seed", str(seed), "--seconds",
                   str(seconds), "--trace", str(trace)], time.time(),
                  root=root, device="cpu")
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)
