"""Share of the traced steps' window in which no device operation ran, in
%."""

from harness import readers


def read(run):
    return readers.idle(run)
