"""``BENCHMARK.json`` and the files it names, found by name under a root."""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def load(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(manifest: dict, name: str, root: Path = ROOT) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            with open(root / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def _json(root: Path, *parts: str) -> dict:
    with open(root.joinpath("portbench", *parts)) as f:
        return json.load(f)


def traffic(name: str, root: Path = ROOT) -> dict:
    return _json(root, "traffic", f"{name}.json")


def limits(cell_name: str, root: Path = ROOT) -> dict:
    """{number: limit} of the cell's comparison with the reference."""
    return _json(root, "limits", f"{cell_name}.json")["limits"]


def applies(metric: dict, cell_name: str, manifest: dict) -> bool:
    """Whether ``metric`` is reported in the cell: it lists the cell, or
    lists no cells and the cell reports the end-to-end metric it moves (a
    per-layer metric without ``workloads`` belongs to every such cell,
    those that later entries add too)."""
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    moves = metric.get("moves")
    if moves is None:
        return True
    target = next(m for m in manifest["end_to_end"] if m["name"] == moves)
    return applies(target, cell_name, manifest)


def end_to_end(manifest: dict, cell_name: str) -> list:
    return [m for m in manifest["end_to_end"] if applies(m, cell_name, manifest)]


def per_layer(manifest: dict, cell_name: str) -> list:
    return [m for m in manifest["per_layer"] if applies(m, cell_name, manifest)]


def _module(root: Path, folder: str, name: str):
    """``portbench/<folder>/<name>.py`` under ``root``, loaded by its path."""
    path = root / "portbench" / folder / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {path.relative_to(root)}")
    key = f"portbench_{folder}_" + "".join(
        ch if ch.isalnum() else "_" for ch in name)
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[key] = module
    spec.loader.exec_module(module)
    return module


def driver(kind: str, root: Path = ROOT):
    """The driver of a traffic mix's ``kind``: ``portbench/drivers/<kind>.py``,
    with ``run(ctx)``, ``control(ctx)`` and ``FAULTS`` ({name: a context
    manager that plants the fault in the program})."""
    return _module(root, "drivers", kind)


def reader(name: str, root: Path = ROOT):
    """The ``read(run)`` function of ``portbench/metrics/<name>.py``."""
    return _module(root, "metrics", name).read
