"""Device ms of the trainer's forward stage, train/trainer.py::step_forward
(CUDA events)."""

from harness import readers


def read(run):
    return readers.stage(run, "forward_ms")
