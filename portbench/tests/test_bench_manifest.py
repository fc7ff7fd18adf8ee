"""BENCHMARK.json against the contract's form, and its files found by name."""

import json
import re

import pytest
from conftest import ROOT, copy_root, run_cell

from harness import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    return manifest.load()


def test_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    for n in names:
        assert NAME.match(n), n
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in bench[k]}) == len(bench[k])
    metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and w["chips"] == 1
        assert LINE.match(w["why"])
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        for key in c["reduced"]:
            assert NAME.match(key)


def test_units_and_metric_keys(bench):
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                          "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert LINE.match(m["layer"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        if m["unit"] == "%" and ("roofline" in m["name"] or "mfu" in m["name"]):
            assert m["better"] == "higher"


def test_every_cell_finds_its_files(bench):
    for w in bench["workloads"]:
        cfg = manifest.config(bench, w["config"])
        mix = manifest.traffic(w["traffic"])
        driver = manifest.driver(mix["kind"])
        assert callable(driver.run) and callable(driver.control)
        assert driver.FAULTS and all(callable(f) for f in driver.FAULTS.values())
        assert manifest.limits(w["name"])
        assert cfg["name"] == w["config"]
        for m in manifest.per_layer(bench, w["name"]):
            assert callable(manifest.reader(m["name"]))
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith(bench["paths"][0] + "/")


def test_moves_reported_in_every_cell(bench):
    """Each per-layer metric's cells all report the end-to-end metric it
    moves, and every cell reports setup_s, one other end-to-end metric and
    a per-layer metric."""
    for m in bench["per_layer"]:
        target = next(e for e in bench["end_to_end"] if e["name"] == m["moves"])
        for w in m["workloads"]:
            assert manifest.applies(target, w, bench), (m["name"], w)
    for w in bench["workloads"]:
        e2e = {m["name"] for m in manifest.end_to_end(bench, w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert manifest.per_layer(bench, w["name"])


ECHO_DRIVER = """
from harness import common


def run(ctx):
    return {"e2e": {"setup_s": common.since(ctx.t_start), "peak_mem_gib": 0.5},
            "numbers": {"echo_gap": 0.0}, "attempted": 3, "failed": 0,
            "peak_bytes": 2**29,
            "run": {"frames": ctx.mix["frames"],
                    "trace": {"busy_s": 1.0, "window_s": 2.0,
                              "device_ops": [], "idle_gaps": []}}}


def control(ctx):
    return {"echo_gap": 1.0}


FAULTS = {}
"""


def test_added_files_are_found_without_an_edit(tmp_path):
    """A configuration, traffic mixes (one of a kind that exists, one of a
    new kind with its driver), a metric and cells added as files and
    entries only are picked up by name, and the new kind's cell runs."""
    root = copy_root(tmp_path, tiny=False)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "portbench/configs/tandt-truck-global.json").read_text())
    cfg["name"] = "added-config"
    (root / "portbench/configs/added-config.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "portbench/traffic/view.json").read_text())
    mix["deg_per_frame"] = 3.0
    (root / "portbench/traffic/view-fast.json").write_text(json.dumps(mix))
    (root / "portbench/traffic/echo.json").write_text(
        json.dumps({"kind": "echo", "frames": 4}))
    (root / "portbench/drivers/echo.py").write_text(ECHO_DRIVER)
    (root / "portbench/limits/added.view-fast.json").write_text(
        json.dumps({"limits": {"frame_mse": 1.0}}))
    (root / "portbench/limits/added.echo.json").write_text(
        json.dumps({"limits": {"echo_gap": 0.5}}))
    (root / "portbench/metrics/added_metric.py").write_text(
        "def read(run):\n    return 2.0 * run['frames']\n")
    bench["configs"].append({"name": "added-config", "source": "x",
                             "file": "portbench/configs/added-config.json",
                             "reduced": [], "why": "added"})
    bench["workloads"].append({"name": "added.view-fast", "config": "added-config",
                               "traffic": "view-fast", "chips": 1, "why": "added"})
    bench["workloads"].append({"name": "added.echo", "config": "added-config",
                               "traffic": "echo", "chips": 1, "why": "added"})
    bench["per_layer"].append({"name": "added_metric", "unit": "1", "better": "lower",
                               "source": "program_counter", "layer": "device",
                               "moves": "peak_mem_gib",
                               "workloads": ["added.view-fast", "added.echo"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    b = manifest.load(root)
    assert manifest.config(b, "added-config", root)["name"] == "added-config"
    assert manifest.traffic("view-fast", root)["deg_per_frame"] == 3.0
    assert manifest.limits("added.view-fast", root) == {"frame_mse": 1.0}
    names = [m["name"] for m in manifest.per_layer(b, "added.view-fast")]
    assert names == ["added_metric"]
    assert manifest.reader("added_metric", root)({"frames": 4}) == 8.0
    assert manifest.driver("echo", root).control(None) == {"echo_gap": 1.0}

    rc, res = run_cell(root, "added.echo")
    assert rc == 0 and res["correct"] is True, res
    assert set(res["metrics"]) == {"setup_s", "peak_mem_gib"}
    assert res["checks"] == {"echo_gap": {"value": 0.0, "limit": 0.5}}
    rc, res = run_cell(root, "added.echo", trace=1)
    assert rc == 0 and res["metrics"] == {"added_metric": {"value": 8.0, "unit": "1"}}
    assert res["device"]["busy_s"] == 1.0 and res["breakdown"]["device_ops"] == []


def test_a_metric_without_workloads_goes_where_its_moves_goes(bench):
    """A per-layer metric that lists no cells is reported in every cell
    that reports the end-to-end metric it moves, and in no other."""
    for e2e in bench["end_to_end"]:
        metric = {"name": "unlisted", "moves": e2e["name"]}
        for w in bench["workloads"]:
            assert (manifest.applies(metric, w["name"], bench)
                    == manifest.applies(e2e, w["name"], bench))
    assert any(not manifest.applies({"moves": "frame_ms"}, w["name"], bench)
               for w in bench["workloads"])


def test_no_driver_stands_in_for_a_missing_kind():
    with pytest.raises(KeyError, match="drivers/replay.py"):
        manifest.driver("replay")
