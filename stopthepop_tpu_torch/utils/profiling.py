"""Stage timing and profiling (torch).

Port of ``stopthepop_tpu/utils/profiling.py``, the reference's ``Timer``
(rasterizer_impl.h:77-147): a per-stage wall-clock accumulator over the
pipeline stages {Preprocess, Duplicate, Sort, Render}, averaged over
128-frame intervals and reported as a text block (the reference emits it
into DebugVisualizationData::timings_text every 128 frames,
rasterizer_impl.cu:389-400).

CUDA work is asynchronous, so ``StageTimer.time`` synchronizes the device
before it reads the clock at either end of a stage (where the JAX timer
calls ``block_until_ready``): a stage's time is its host dispatch plus its
device work. ``trace`` records a ``torch.profiler`` trace with per-kernel
device times.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Callable

import torch

REPORT_INTERVAL = 128  # frames, like the reference (rasterizer_impl.h:80)

STAGES = ("Preprocess", "Duplicate", "Sort", "Render")  # reference stage names


def _sync():
    """Wait for the GPU's queued work, where CUDA has been used."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StageTimer:
    """Accumulates per-stage wall time; reports ``interval``-frame averages."""

    def __init__(self, enabled: bool = True, interval: int = REPORT_INTERVAL):
        self.enabled = enabled
        self.interval = interval
        self._acc = defaultdict(float)   # stage -> seconds in this interval
        self._order = []
        self._frames = 0
        self.timings_text = ""

    def time(self, stage: str, fn: Callable, *args, **kw):
        """Run ``fn`` as one timed stage (the device synchronized at both
        ends)."""
        if not self.enabled:
            return fn(*args, **kw)
        _sync()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        _sync()
        self._record(stage, time.perf_counter() - t0)
        return out

    @contextlib.contextmanager
    def stage(self, stage: str):
        """Context-manager form (the device synchronized at both ends)."""
        if not self.enabled:
            yield
            return
        _sync()
        t0 = time.perf_counter()
        yield
        _sync()
        self._record(stage, time.perf_counter() - t0)

    def _record(self, stage: str, dt: float):
        if stage not in self._acc:
            self._order.append(stage)
        self._acc[stage] += dt

    def _lines(self, n: int) -> str:
        return "\n".join(f"{s}: {1000.0 * self._acc[s] / n:.3f} ms"
                         for s in self._order)

    def frame(self):
        """Mark a frame boundary; refresh the report every ``interval``."""
        if not self.enabled:
            return
        self._frames += 1
        if self._frames >= self.interval:
            self.timings_text = self._lines(self._frames)
            self._acc = defaultdict(float)
            self._order = []
            self._frames = 0

    def report(self) -> str:
        """Immediate report of the current (partial) interval."""
        return self._lines(max(self._frames, 1))


@contextlib.contextmanager
def trace(log_dir: str):
    """A ``torch.profiler`` trace of the body (CPU, and CUDA where a GPU is
    present), written to ``log_dir/trace.json`` (Chrome trace format) on
    exit. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
