"""The backward blend's least time (the reference's counted operations and
bytes, harness/counts.py) over its device time per step, in %."""

from harness import counts, readers


def read(run):
    return readers.roofline(run, readers.BWD_BLEND, counts.blend_bwd_ops,
                            counts.blend_bwd_bytes)
