"""A frame's counted float32 operations (harness/counts.py::frame_ops) over
frame_ms and the H100's float32 peak, in %."""

from harness import counts, readers


def read(run):
    return readers.mfu(run, counts.frame_ops, "frame_ms")
