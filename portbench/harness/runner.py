"""One run of one cell: set-up, the window, the check, one result line.

The last line on standard output is the result, a JSON object with
``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``, and last ``checks``: each number compared
with its limit. The same numbers and limits are the last lines on standard
error. Without the cards the cell asks for, or with JAX or the JAX package
loaded once the window has closed, the run prints no result and exits
non-zero.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "stopthepop_tpu")


def forbidden_modules(names=None) -> list:
    """Top-level names among ``names`` (the loaded modules by default) that
    a run may not load, compared whole (``stopthepop_tpu_torch`` is not
    ``stopthepop_tpu``)."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def _finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def _cache_dirs(root: Path):
    """Kernel and build caches at fixed paths inside the checkout."""
    cache = root / "build" / "portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"


def parse(argv):
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t_start: float, *, root: Path | None = None,
         device: str = "cuda") -> int:
    """Run the cell; ``device="cpu"`` skips the look for cards (tests)."""
    from . import check, common, manifest

    root = manifest.ROOT if root is None else root
    args = parse(argv)
    bench = manifest.load(root)
    cell = manifest.cell(bench, args.workload)
    cfg = manifest.config(bench, cell["config"], root)
    mix = manifest.traffic(cell["traffic"], root)
    limits = manifest.limits(cell["name"], root)
    _cache_dirs(root)
    import torch

    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < cell["chips"]):
        print(f"{cell['name']} needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    ctx = common.Ctx(cell=cell, cfg=cfg, mix=mix, seed=args.seed,
                     seconds=args.seconds, trace=bool(args.trace),
                     device=torch.device(device), t_start=t_start)
    ctx.mark("torch")
    out = manifest.driver(mix["kind"], root).run(ctx)
    if args.trace:
        metrics = {}
        for m in manifest.per_layer(bench, cell["name"]):
            value = manifest.reader(m["name"], root)(out["run"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out["e2e"][m["name"]], "unit": m["unit"]}
                   for m in manifest.end_to_end(bench, cell["name"])}
    correct, checks = check.judge(out["numbers"], limits)
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else "cpu"),
           "count": cell["chips"], "memory_peak_bytes": out["peak_bytes"]}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": dev}
    if args.trace:
        tr = out["run"]["trace"]
        dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["window_s"]
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    result["checks"] = {k: {"value": _finite(c["value"]), "limit": c["limit"]}
                        for k, c in checks.items()}
    loaded = forbidden_modules()
    if loaded:
        print(f"forbidden modules loaded: {', '.join(loaded)}", file=sys.stderr)
        return 3
    print("set-up: " + ", ".join(f"{what} {t:.3f} s" for what, t in ctx.marks),
          file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0
