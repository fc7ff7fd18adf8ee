#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, from the root of a checkout:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

It measures the PyTorch/CUDA port (``stopthepop_tpu_torch``) on one or more
CUDA devices and prints one JSON result as its last line (see
``portbench/README.md``). Without the CUDA devices the cell asks for it
exits non-zero and prints no result.
"""

import sys
import time

T_START = time.time()

if __name__ == "__main__":
    from pathlib import Path

    here = Path(__file__).resolve().parent
    sys.path.insert(0, str(here))
    sys.path.insert(1, str(here.parent))
    from harness.runner import main

    sys.exit(main(sys.argv[1:], T_START))
