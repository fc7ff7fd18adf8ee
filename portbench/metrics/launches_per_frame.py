"""Kernel launches per traced frame."""

from harness import readers


def read(run):
    return readers.launches(run)
