"""Kernel launches per traced step."""

from harness import readers


def read(run):
    return readers.launches(run)
