"""Device ms per step of the forward blend kernels inside a training step,
by name, from the traced steps."""

from harness import readers


def read(run):
    return readers.kernel_ms(run, readers.FWD_BLEND)
