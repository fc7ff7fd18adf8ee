"""Device ms of the trainer's Adam stage, train/trainer.py::step_update
(CUDA events)."""

from harness import readers


def read(run):
    return readers.stage(run, "optimizer_ms")
