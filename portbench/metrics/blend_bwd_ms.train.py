"""Device ms per step of the backward blend kernels, by name, from the
traced steps."""

from harness import readers


def read(run):
    return readers.kernel_ms(run, readers.BWD_BLEND)
