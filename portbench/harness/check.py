"""The numbers that decide ``correct``, each against its limit.

A frame is compared by its mean squared difference from the reference's
frame of the same camera (over pixels and channels). A training run by the
gaps of norms, leaf by leaf, of its first gradient and of its change over
the first steps, each against the reference's norm of the leaf or the
median leaf's, whichever is larger, and by the relative gap of each
step's loss.
"""

from __future__ import annotations

import math

import torch


def frame_mse(got, want) -> float:
    d = got.float() - want.float()
    mse = float(torch.mean(d * d))
    return mse if math.isfinite(mse) else math.inf


def _median(values):
    s = sorted(values)
    return 0.5 * (s[(len(s) - 1) // 2] + s[len(s) // 2])


def norm_gap(got: dict, want: dict, leaves=None) -> float:
    """max over ``leaves`` (all of ``want``'s by default) of
    |‖got‖ - ‖want‖| / max(‖want‖, the median leaf's ‖want‖)."""
    median = _median(list(want.values()))
    worst = 0.0
    for k in (want if leaves is None else leaves):
        gap = abs(got[k] - want[k]) / max(want[k], median)
        if not math.isfinite(gap):
            return math.inf
        worst = max(worst, gap)
    return worst


def loss_gap(got, want) -> float:
    gaps = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    return max(g if math.isfinite(g) else math.inf for g in gaps)


def judge(numbers: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}): every limit has a finite
    number at or under it."""
    checks = {k: {"value": numbers.get(k, math.inf), "limit": v}
              for k, v in limits.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
