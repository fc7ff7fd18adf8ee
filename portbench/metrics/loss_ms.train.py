"""Device ms of the program's rgb_loss forward and backward alone at the
cell's image size (CUDA events, from outside)."""

from harness import readers


def read(run):
    return readers.stage(run, "loss_ms")
