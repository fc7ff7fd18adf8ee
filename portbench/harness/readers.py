"""What the per-layer metric readers (``portbench/metrics/<name>.py``)
share. Each takes the run's record (``run``: ``frames`` or ``steps``,
``frame_ms`` or ``step_ms``, and in a traced run ``trace``, ``stage_ms``
and the reference's event counts ``counts`` per frame or step) and returns
a number, or None where the record holds nothing to read."""

from __future__ import annotations

import re

from . import counts

FWD_BLEND = r"(global|hier|kbuffer|full)_blend_fwd_kernel"
BWD_BLEND = r"(global|hier|kbuffer)_blend_bwd_kernel"


def stage(run, key):
    return run.get("stage_ms", {}).get(key)


def kernel_ms(run, pattern):
    """Device ms per traced frame or step of the kernels named ``pattern``."""
    tr = run.get("trace")
    if tr is None:
        return None
    us = sum(v for k, v in tr["device_us_by_name"].items() if re.search(pattern, k))
    return us / 1e3 / tr["units"] if us > 0 else None


def roofline(run, pattern, ops_fn, bytes_fn):
    """Least time of the counted work over the kernels' time, in %."""
    ms, n = kernel_ms(run, pattern), run.get("counts")
    if ms is None or n is None:
        return None
    least = counts.least_s(ops_fn(n, run["config"]), bytes_fn(n, run["config"]))
    return 100.0 * least / (ms / 1e3)


def idle(run):
    tr = run.get("trace")
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def launches(run):
    tr = run.get("trace")
    return None if tr is None else tr["launches"] / tr["units"]


def mfu(run, ops_fn, time_key):
    """Counted operations of a frame or step over its time and the peak."""
    n = run.get("counts")
    if n is None or run.get(time_key) is None:
        return None
    ops = ops_fn(n, run["config"])
    return 100.0 * ops / (run[time_key] / 1e3) / counts.PEAK_FP32_OPS_S
