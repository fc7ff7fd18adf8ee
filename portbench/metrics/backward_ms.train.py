"""Device ms of the trainer's backward stage,
train/trainer.py::step_backward (CUDA events)."""

from harness import readers


def read(run):
    return readers.stage(run, "backward_ms")
