#!/usr/bin/env python3
"""Read the numbers a cell's limits are set from, in one process:

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3 \\
        [--control-seeds 4,5,6] [--fault-seeds 7,8,9] [--seconds 2]

For each of ``--seeds`` it makes a sound run of the cell (a window of
``--seconds``) and prints the numbers it compares. For each of
``--control-seeds`` it prints the control's: the reference computed in
bfloat16 (``reference/``'s ``lowp``) against the float32 reference at the
cell's own size, on the frames or steps a run compares. For each of
``--fault-seeds`` it runs the cell with each fault of its driver's
``FAULTS`` planted in the program. The cell's driver
(``drivers/<kind>.py``) makes each of these readings. One JSON line per
reading; the benchmark's own runs do not run this.
"""

import json
import sys
import time
from pathlib import Path

here = Path(__file__).resolve().parent
sys.path.insert(0, str(here))
sys.path.insert(1, str(here.parent))


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def main(argv=None, root=None):
    import argparse

    import torch

    from harness import common, manifest

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_seeds, default=[])
    ap.add_argument("--control-seeds", type=_seeds, default=[])
    ap.add_argument("--fault-seeds", type=_seeds, default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    root = manifest.ROOT if root is None else root
    bench = manifest.load(root)
    cell = manifest.cell(bench, args.workload)
    cfg = manifest.config(bench, cell["config"], root)
    mix = manifest.traffic(cell["traffic"], root)
    driver = manifest.driver(mix["kind"], root)
    dev = torch.device(args.device)

    def ctx(seed):
        return common.Ctx(cell=cell, cfg=cfg, mix=mix, seed=seed,
                          seconds=args.seconds, trace=False, device=dev,
                          t_start=time.time())

    def emit(kind, seed, numbers, **extra):
        print(json.dumps({"cell": cell["name"], "kind": kind, "seed": seed,
                          "numbers": numbers, **extra}), flush=True)

    for seed in args.seeds:
        t0 = time.time()
        out = driver.run(ctx(seed))
        emit("sound", seed, out["numbers"], e2e=out["e2e"],
             seconds=time.time() - t0)
        common.free(dev)
    for seed in args.control_seeds:
        emit("control", seed, driver.control(ctx(seed)))
        common.free(dev)
    for seed in args.fault_seeds:
        for name, plant in driver.FAULTS.items():
            with plant():
                emit(name, seed, driver.run(ctx(seed))["numbers"])
            common.free(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
