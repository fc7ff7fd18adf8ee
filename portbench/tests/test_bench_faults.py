"""A whole run at a tiny size on the CPU (the look for a card skipped):
sound, ``correct`` comes out true; with each fault of the cell's driver
(``drivers/<kind>.py``'s ``FAULTS``) planted in the program underneath,
false."""

import pytest
from conftest import run_cell

from harness import manifest


@pytest.mark.parametrize("workload", ["truck-global.view", "truck-global.train",
                                      "bicycle-hier.view"])
def test_sound_run_is_correct(tiny_root, workload):
    rc, res = run_cell(tiny_root, workload)
    assert rc == 0 and res["correct"], res
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) >= {"setup_s", "peak_mem_gib"}


@pytest.mark.parametrize("workload,fault", [
    ("truck-global.view", "altered_frame"),
    ("truck-global.train", "half_batch"),
    ("truck-global.train", "frozen_state"),
])
def test_planted_fault_is_caught(tiny_root, workload, fault):
    bench = manifest.load(tiny_root)
    kind = manifest.traffic(manifest.cell(bench, workload)["traffic"], tiny_root)["kind"]
    with manifest.driver(kind, tiny_root).FAULTS[fault]():
        rc, res = run_cell(tiny_root, workload)
    assert rc == 0 and res["correct"] is False, res
    assert any(c["value"] is None or c["value"] > c["limit"]
               for c in res["checks"].values())
