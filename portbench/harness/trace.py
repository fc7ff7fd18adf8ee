"""Device timings: CUDA events, and torch.profiler's trace of a window.

``cuda_ms`` is chip_smoke.py's: CUDA events around many calls after a
warm-up. ``profile`` records a window of calls with torch.profiler (host
and device), reads the exported Chrome trace and reduces it to what the
metric readers take: device operations by name, launches, the union of the
device's busy intervals, and the idle gaps between device operations
labelled by what the host was doing.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
NAME_CHARS = 100


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of fn() in ms over ``iters`` calls, CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profile(fn, n: int, label: str) -> dict:
    """torch.profiler over ``fn(i)`` for i < n, each call inside a
    ``record_function(label)`` range; returns ``summarize`` of its trace."""
    from torch.profiler import ProfilerActivity, profile as prof_ctx, record_function

    torch.cuda.synchronize()
    with prof_ctx(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            with record_function(label):
                fn(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return summarize(events, wall, n, label)


def _union_us(intervals):
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def summarize(events, wall_s: float, units: int, label: str) -> dict:
    """Device operations of a Chrome trace ("ph": "X", categories
    ``DEVICE_CATS``), reduced per traced call (``units`` calls of
    ``label``) and over the window of ``wall_s`` seconds."""
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    host = sorted((e for e in events if e.get("ph") == "X"
                   and e.get("cat") in HOST_CATS),
                  key=lambda e: e["ts"])
    marks = [e for e in host if e.get("cat") == "user_annotation"
             and e.get("name") == label]
    by_name = defaultdict(float)
    launches = 0
    for e in dev:
        by_name[e["name"]] += float(e["dur"])
        launches += e.get("cat") == "kernel"
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev)
    starts = [float(e["ts"]) for e in host]
    gaps = defaultdict(float)
    cursor = float(marks[0]["ts"]) if marks else (spans[0][0] if spans else 0.0)
    for s, e in spans:
        if s > cursor:
            gaps[_host_label(host, starts, marks, 0.5 * (cursor + s), label)] += s - cursor
        cursor = max(cursor, e)

    def top(d):
        return [[k[:NAME_CHARS], v / 1e6] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    return {"units": units, "window_s": wall_s,
            "busy_s": _union_us(spans) / 1e6, "launches": launches,
            "device_us_by_name": dict(by_name),
            "device_ops": top(by_name), "idle_gaps": top(gaps)}


def _host_label(host, starts, marks, t, label):
    """``label`` (or "outside") and the innermost host operation running
    at time ``t`` (µs), or "no op" where the host runs Python between
    operations."""
    where = next((label for m in marks if m["ts"] <= t <= m["ts"] + m["dur"]),
                 "outside")
    i = bisect.bisect_right(starts, t)
    for e in reversed(host[max(0, i - 2000):i]):
        if e.get("cat") != "user_annotation" and e["ts"] + e["dur"] >= t:
            return f"{where}: {e['name']}"
    return f"{where}: no op"
