"""GLOBAL's counts (``counts.py``): only the blends of the reference's pass
(``reference/blend_global.py``). Each needs its alpha and its blend, or its
alpha and its gradient; the evaluations that end in a skip are not counted,
since a kernel may cull them unseen."""

from .counts import OPS_PER_BLEND, OPS_PER_BLEND_BWD, OPS_PER_EVAL

# A Gaussian's blend rows: xy (8), conic and opacity (16), rgb (12), depth (4).
ROW_BYTES = 40


def blend_ops(n: dict, cfg: dict) -> float:
    return (OPS_PER_EVAL + OPS_PER_BLEND) * n["blends"]


def blend_bwd_ops(n: dict, cfg: dict) -> float:
    return (OPS_PER_EVAL + OPS_PER_BLEND_BWD) * n["blends"]
