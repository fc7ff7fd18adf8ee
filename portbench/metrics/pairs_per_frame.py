"""The program's pair count (RenderOutput.num_rendered), mean over the
window's frames."""


def read(run):
    return run.get("pairs_per_frame")
