"""PER_PIXEL_FULL's counts (``counts.py``), per event of the reference's
exact per-pixel sort (``reference/blend_ppx_full.py``): each pixel's
evaluation of every pair of its tile, the ray depth of each active, and
each commit. What a kernel does more to sort the actives (compares, or
streaming a segment again in passes) is not counted, so the least time is
a lower bound on the work."""

from .counts import OPS_PER_EVAL
from .counts_hier import OPS_PER_COMMIT, OPS_PER_DEPTH

# A Gaussian's blend rows: xy (8), conic and opacity (16), rgb (12), the
# packed inverse covariance (36).
ROW_BYTES = 72


def blend_ops(n: dict, cfg: dict) -> float:
    """An alpha per evaluation (11), a ray depth per active (24), a blend
    per commit (10)."""
    return (OPS_PER_EVAL * n["evaluations"] + OPS_PER_DEPTH * n["actives"]
            + OPS_PER_COMMIT * n["commits"])


def blend_bwd_ops(n: dict, cfg: dict) -> float:
    raise NotImplementedError(
        "PER_PIXEL_FULL renders forward only (the reference's backward.cu:"
        "733-736 throws); no training cell can count its backward")
