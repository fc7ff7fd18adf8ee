"""Kernel K7's passes over its tiles' segments per tile, over every frame
the run rendered: the program's own counter
(``kernels/full_blend.py::pass_counts``), read in the run's process after
the run. None where the program has no such counter or counted no K7
tile."""


def read(run):
    from stopthepop_tpu_torch.kernels import full_blend

    pass_counts = getattr(full_blend, "pass_counts", None)
    if pass_counts is None:
        return None
    passes, tiles = pass_counts()
    return passes / tiles if tiles else None
