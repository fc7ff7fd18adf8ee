"""Device ms per frame of the forward blend kernels, by name, from the
traced frames."""

from harness import readers


def read(run):
    return readers.kernel_ms(run, readers.FWD_BLEND)
