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

``span(name)`` marks a layer of the program: while a ``torch.profiler``
session is active it opens a ``record_function`` range named
``stp/<name>``, which lands in the same trace as the device's kernels, on
the profiler's clock. While a ``StageTimer`` listens (``listening``), the
spans it maps to the reference's stages are timed as those stages. With
neither, ``span`` makes one check of each and returns a shared no-op
context manager. The spans the program opens:

  stp/params      the model's activated parameters (render/cli.py::
                  render_model; train/trainer.py::step_forward)
  stp/preprocess  preprocess and the means2D reroute (render/rasterize.py),
                  holding, where no gradient is wanted on a CUDA device,
  stp/preprocess_kernel  the launch of kernel K8 (render/preprocess.py)
  stp/pairs       pairs on the binning grid and their blend tiles
                  (render/pipeline.py::_binned_pairs), holding
  stp/duplicate   the expansion and its pair-count read (render/duplicate.py)
  stp/sort        the (tile, depth) sort and the tile ranges
  stp/blend       the blend kernel and the background composite
  stp/forward     a training step's render and loss, holding stp/loss
  stp/backward    a training step's backward, holding stp/blend_bwd (the
                  blend's backward kernel and per-Gaussian sum, on
                  autograd's thread)
  stp/update      a training step's optimizer stage

Beside the spans, the program keeps counters that no trace shows:

  kernels/full_blend.py::pass_counts()  (passes, tiles) of kernel K7 in
                  stp/blend (PER_PIXEL_FULL): its passes over the tiles'
                  segments, added on the device by each block, and the
                  tiles launched, summed over the process's launches; the
                  call waits for the device, so read it after the frames
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Callable

import torch
from torch.autograd.profiler import record_function

REPORT_INTERVAL = 128  # frames, like the reference (rasterizer_impl.h:80)

STAGES = ("Preprocess", "Duplicate", "Sort", "Render")  # reference stage names

SPAN_PREFIX = "stp/"
# The program's spans a listening StageTimer times, as the reference's stages.
STAGE_OF_SPAN = {"preprocess": "Preprocess", "duplicate": "Duplicate",
                 "sort": "Sort", "blend": "Render"}

_profiler_enabled = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()
# StageTimers inside ``listening``: process-wide, since autograd runs a
# backward's spans on a thread of its own.
_LISTENERS: list = []


def span(name: str):
    """A context manager marking one layer of the program as ``stp/<name>``
    (module notes). With no profiler active and no timer listening it is a
    shared no-op."""
    traced = _profiler_enabled()
    if _LISTENERS:
        return _listened(name, traced)
    if traced:
        return record_function(SPAN_PREFIX + name)
    return _OFF


@contextlib.contextmanager
def _listened(name: str, traced: bool):
    """The span timed by each listening StageTimer that maps it to a
    stage, and recorded where ``traced``."""
    with contextlib.ExitStack() as stack:
        stage = STAGE_OF_SPAN.get(name)
        if stage is not None:
            for timer in list(_LISTENERS):
                stack.enter_context(timer.stage(stage))
        if traced:
            stack.enter_context(record_function(SPAN_PREFIX + name))
        yield


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

    @contextlib.contextmanager
    def listening(self):
        """Time the program's spans ``stp/preprocess``, ``stp/duplicate``,
        ``stp/sort`` and ``stp/blend`` opened in the body as the stages
        Preprocess, Duplicate, Sort and Render (``STAGE_OF_SPAN``), each
        synchronized at both ends, in every sort mode."""
        if not self.enabled:
            yield
            return
        _LISTENERS.append(self)
        try:
            yield
        finally:
            _LISTENERS.remove(self)

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
