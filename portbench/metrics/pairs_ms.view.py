"""Device ms of the program's pair build and sort at the compared cameras
(CUDA events, from outside; the one read of the pair count included)."""

from harness import readers


def read(run):
    return readers.stage(run, "pairs_ms")
