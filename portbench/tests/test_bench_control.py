"""The control, the reference computed in bfloat16 in the program's place,
fails a number of each cell: at a tiny size on the CPU, and at the cell's
own size on the card."""

import json
import subprocess
import sys

import pytest
from conftest import BENCH, ROOT

from harness import common, manifest


def _control(root, workload, seed, device):
    bench = manifest.load(root)
    cell = manifest.cell(bench, workload)
    mix = manifest.traffic(cell["traffic"], root)
    ctx = common.Ctx(cell=cell, cfg=manifest.config(bench, cell["config"], root),
                     mix=mix, seed=seed, seconds=0.0, trace=False,
                     device=device, t_start=0.0)
    numbers = manifest.driver(mix["kind"], root).control(ctx)
    limits = manifest.limits(workload, root)
    return [k for k, v in numbers.items() if v > limits[k]]


@pytest.mark.parametrize("workload", ["truck-global.view", "truck-global.train",
                                      "bicycle-hier.view"])
def test_control_fails_at_a_tiny_size(tiny_root, workload):
    import torch

    assert _control(tiny_root, workload, 41, torch.device("cpu"))


@pytest.mark.card
@pytest.mark.parametrize("workload", [w["name"] for w in manifest.load()["workloads"]])
def test_control_fails_at_the_cells_size(card, workload):
    out = subprocess.run(
        [sys.executable, str(BENCH / "calibrate.py"), "--workload", workload,
         "--control-seeds", "4101,4102,4103"],
        cwd=str(ROOT), capture_output=True, text=True, timeout=3000)
    assert out.returncode == 0, out.stderr[-2000:]
    limits = manifest.limits(workload)
    for line in out.stdout.strip().splitlines():
        numbers = json.loads(line)["numbers"]
        assert any(v > limits[k] for k, v in numbers.items()), numbers
