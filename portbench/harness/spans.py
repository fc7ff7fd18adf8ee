"""The program's spans in a torch.profiler trace, reduced per layer.

The program marks each layer of a frame or a training step with a
``record_function`` range named ``stp/<name>`` (its
``utils/profiling.py::span``), opened only while a profiler is active. The
ranges sit in the same Chrome trace as the device's kernels, on the
profiler's clock. ``reduce`` puts the device's work and idle time down to
them:

- a device operation (kernel, memcpy, memset) belongs to the spans open
  when its launch call was made, the launch found by the ``correlation``
  id in ``args``. A span's instances are matched on any thread by time, so
  the blend's backward, launched by autograd's own thread, falls in
  ``stp/blend_bwd`` and ``stp/backward``. The innermost span is the open
  instance that started last;
- ``busy_ms``: the union of the device intervals of the operations that
  belong to the span (its children's included); ``self_busy_ms`` of those
  whose innermost span it is; ``launches``: the kernels among them;
- ``idle_ms``: device-idle time inside the units' marks (the ``label``
  ranges of ``trace.profile``) while the span was open on the host;
  ``self_idle_ms`` while it was the innermost open span;
- ``syncs``: host calls that wait for the device (``SYNC_CALLS``) made while
  the span was open; ``host_ms`` and ``count``: its instances' host time
  and number.

Each number is per unit (traced frame or step). ``ANY`` (``stp/*``) holds
the same numbers for the union of all spans. A trace without ``stp/``
ranges (a program without spans) reduces to an empty dict.
``breakdown.py`` prints this reduction of a cell's traced segment.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

from .trace import DEVICE_CATS

PREFIX = "stp/"
ANY = PREFIX + "*"
CALL_CATS = ("cuda_runtime", "cuda_driver")
SYNC_CALLS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                        "cudaEventSynchronize", "cudaMemcpy"})
KEYS = ("busy_ms", "self_busy_ms", "launches", "idle_ms", "self_idle_ms",
        "syncs", "host_ms", "count")


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _length(intervals):
    return sum(e - s for s, e in _merge(intervals))


class _Timeline:
    """The span instances open between consecutive span boundaries."""

    def __init__(self, inst):
        self.bounds = sorted({t for s, e, _ in inst for t in (s, e)})
        self.open = []
        for a, b in zip(self.bounds, self.bounds[1:]):
            here = [i for i in inst if i[0] <= a and b <= i[1]]
            names = frozenset(n for _, _, n in here)
            inner = max(here, key=lambda i: (i[0], -i[1]))[2] if here else None
            self.open.append((names, inner))

    def at(self, t):
        """(names of the open spans, the innermost one's) at time ``t``."""
        k = bisect.bisect_right(self.bounds, t) - 1
        if 0 <= k < len(self.open):
            return self.open[k]
        return frozenset(), None

    def pieces(self, a, b):
        """[(length, names, innermost)] of the interval [a, b] cut at the
        span boundaries."""
        out, k = [], max(0, bisect.bisect_right(self.bounds, a) - 1)
        while a < b:
            if k >= len(self.open) or a < self.bounds[0]:
                nxt = self.bounds[0] if a < self.bounds[0] else b
                out.append((min(nxt, b) - a, frozenset(), None))
                a = min(nxt, b)
                continue
            end = min(self.bounds[k + 1], b)
            names, inner = self.open[k]
            out.append((end - a, names, inner))
            a, k = end, k + 1
        return out


def reduce(events, units: int, label: str | None = None) -> dict:
    """{span name: {``KEYS``: value per unit}} of the ``stp/`` ranges in
    the Chrome trace ``events``, with ``ANY`` for their union; the units'
    marks are the ``label`` ranges (module notes)."""
    xs = [e for e in events if e.get("ph") == "X"]
    inst = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
            for e in xs if e.get("cat") == "user_annotation"
            and e.get("name", "").startswith(PREFIX)]
    if not inst:
        return {}
    line = _Timeline(inst)
    launch_ts = {e["args"]["correlation"]: float(e["ts"]) for e in xs
                 if e.get("cat") in CALL_CATS
                 and "correlation" in e.get("args", {})}
    stats = defaultdict(lambda: dict.fromkeys(KEYS, 0.0))
    busy, self_busy = defaultdict(list), defaultdict(list)
    dev = []
    for e in xs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        s = float(e["ts"])
        dev.append((s, s + float(e["dur"])))
        t = launch_ts.get(e.get("args", {}).get("correlation"))
        if t is None:
            continue
        names, inner = line.at(t)
        for n in names | ({ANY} if names else set()):
            busy[n].append(dev[-1])
            stats[n]["launches"] += e.get("cat") == "kernel"
        if inner is not None:
            self_busy[inner].append(dev[-1])
    for e in xs:
        if e.get("cat") in CALL_CATS and e.get("name") in SYNC_CALLS:
            names, _ = line.at(float(e["ts"]))
            for n in names | ({ANY} if names else set()):
                stats[n]["syncs"] += 1
    marks = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in xs
             if e.get("cat") == "user_annotation" and e.get("name") == label]
    if not marks:
        marks = [(line.bounds[0], line.bounds[-1])]
    merged = _merge(dev)
    for m0, m1 in marks:
        cursor = m0
        for s, e in merged + [[m1, m1]]:
            if e <= cursor or s <= cursor <= e:
                cursor = max(cursor, e)
                continue
            for length, names, inner in line.pieces(cursor, min(s, m1)):
                for n in names | ({ANY} if names else set()):
                    stats[n]["idle_ms"] += length
                if inner is not None:
                    stats[inner]["self_idle_ms"] += length
            cursor = max(cursor, e)
            if cursor >= m1:
                break
    for s, e, n in inst:
        stats[n]["host_ms"] += e - s
        stats[n]["count"] += 1
    stats[ANY]["host_ms"] = _length([(s, e) for s, e, _ in inst])
    stats[ANY]["count"] = len(inst)
    for n, v in busy.items():
        stats[n]["busy_ms"] = _length(v)
    for n, v in self_busy.items():
        stats[n]["self_busy_ms"] = _length(v)
    stats[ANY]["self_busy_ms"] = stats[ANY]["busy_ms"]
    stats[ANY]["self_idle_ms"] = stats[ANY]["idle_ms"]
    us = {"busy_ms", "self_busy_ms", "idle_ms", "self_idle_ms", "host_ms"}
    return {n: {k: (v / 1e3 if k in us else v) / units for k, v in d.items()}
            for n, d in sorted(stats.items())}

