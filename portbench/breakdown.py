#!/usr/bin/env python3
"""Run one cell traced, as ``run.py --trace 1`` does, and print after its
result line one more JSON line, ``{"spans": ...}``: the program's ``stp/``
spans in the traced frames or steps, reduced per layer by
``harness/spans.py::reduce`` (busy, self busy, launches, idle, self idle,
syncs, host ms and count, per traced frame or step):

    python3 portbench/breakdown.py --workload <name> --seed <n> --seconds <s>

The benchmark's own runs do not run this, and its result line is the same
as theirs: the reduction is taken beside ``harness/trace.py::summarize``,
which is left as it is.
"""

import contextlib
import json
import sys
import time
from pathlib import Path

T_START = time.time()

here = Path(__file__).resolve().parent
sys.path.insert(0, str(here))
sys.path.insert(1, str(here.parent))


@contextlib.contextmanager
def recording(found: list):
    """While open, each trace ``trace.summarize`` reduces also appends its
    spans' reduction to ``found``; ``summarize``'s own dict is unchanged."""
    from harness import spans, trace

    real = trace.summarize

    def summarize(events, wall_s, units, label):
        found.append(spans.reduce(events, units, label))
        return real(events, wall_s, units, label)

    trace.summarize = summarize
    try:
        yield found
    finally:
        trace.summarize = real


def main(argv, t_start: float = T_START) -> int:
    from harness import runner

    found = []
    with recording(found):
        rc = runner.main(list(argv) + ["--trace", "1"], t_start)
    if rc == 0:
        print(json.dumps({"spans": found[-1] if found else {}}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
