"""The forward blend's least time inside a training step (the reference's
counted operations and bytes, harness/counts.py) over its device time per
step, in %."""

from harness import counts, readers


def read(run):
    return readers.roofline(run, readers.FWD_BLEND, counts.blend_ops,
                            counts.blend_bytes)
