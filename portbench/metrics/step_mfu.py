"""A training step's counted float32 operations
(harness/counts.py::step_ops) over step_ms and the H100's float32 peak,
in %."""

from harness import counts, readers


def read(run):
    return readers.mfu(run, counts.step_ops, "step_ms")
