"""Device ms of the program's preprocess at the compared cameras (CUDA
events, from outside)."""

from harness import readers


def read(run):
    return readers.stage(run, "preprocess_ms")
