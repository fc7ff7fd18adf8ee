"""HIERARCHICAL's counts (``counts.py``), per event of the reference's
cascade (``reference/blend_hier.py``), of the pixels not yet done."""

from .counts import OPS_PER_BLEND_BWD

# A tail key is a ray depth (24); a tail merge places an entry (1); an
# evaluation is an alpha (11) and a head ray depth (24); a mid insert a
# quad's ray depth (24) and km compares and selects for each of its 4
# fields (5 km); a head insert kh of them for 3 fields (4 kh); a commit as
# a blend (10).
OPS_PER_TAIL_KEY, OPS_PER_TAIL_SLOT, OPS_PER_HIER_EVAL = 24, 1, 35
OPS_PER_DEPTH, OPS_PER_MID_SLOT, OPS_PER_HEAD_SLOT = 24, 5, 4
OPS_PER_COMMIT = 10
# A Gaussian's blend rows: xy (8), conic and opacity (16), rgb (12), the
# inverse covariance (36) and the power threshold (4).
ROW_BYTES = 76


def blend_ops(n: dict, cfg: dict) -> float:
    _, km, kh = cfg["queues"]
    return (OPS_PER_TAIL_KEY * n["tail_keys"]
            + OPS_PER_TAIL_SLOT * n["tail_slots"]
            + OPS_PER_HIER_EVAL * n["evaluations"]
            + (OPS_PER_DEPTH + OPS_PER_MID_SLOT * km) * n["mid_inserts"]
            + OPS_PER_HEAD_SLOT * kh * n["head_inserts"]
            + OPS_PER_COMMIT * n["commits"])


def blend_bwd_ops(n: dict, cfg: dict) -> float:
    """The replay of the forward, and each commit's gradient in place of
    its blend."""
    return blend_ops(n, cfg) + (OPS_PER_BLEND_BWD - OPS_PER_COMMIT) * n["commits"]
