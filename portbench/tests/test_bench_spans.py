"""The reduction of the program's ``stp/`` spans (``harness/spans.py``)
against hand-made traces, ``breakdown.py`` that prints it, and a CPU trace
of the program."""

import json

import pytest
import torch
from conftest import ROOT

import breakdown
from harness import spans, trace

MS = 1000.0  # trace times are µs; the hand-made trace counts in ms


def _x(name, cat, ts, dur, tid=1, **args):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts * MS, "dur": dur * MS,
         "pid": 1, "tid": tid}
    if args:
        e["args"] = args
    return e


def _launch(ts, corr, tid=1, name="cudaLaunchKernel"):
    return _x(name, "cuda_runtime", ts, 0.5, tid, correlation=corr)


def _events(with_spans=True):
    """One frame mark [0, 100] ms. Spans: pairs [10, 50] holding sort
    [30, 45]; blend [60, 90]; blend_bwd [62, 70] on another thread. Device:
    k1 [20, 40] launched at 12 (pairs), k2 [35, 50] at 32 (sort), a memcpy
    [50, 52] at 33 (sort), k3 [70, 80] at 63 on thread 2 (blend_bwd), k4
    [96, 99] at 95 (no span). Syncs at 40 (sort) and 55 (no span)."""
    ev = [_x("frame", "user_annotation", 0, 100),
          _launch(12, 1), _launch(32, 2),
          _launch(33, 5, name="cudaMemcpyAsync"),
          _launch(63, 3, tid=2), _launch(95, 4),
          _x("k1", "kernel", 20, 20, 7, correlation=1),
          _x("k2", "kernel", 35, 15, 7, correlation=2),
          _x("Memcpy DtoH", "gpu_memcpy", 50, 2, 7, correlation=5),
          _x("k3", "kernel", 70, 10, 7, correlation=3),
          _x("k4", "kernel", 96, 3, 7, correlation=4),
          _x("cudaStreamSynchronize", "cuda_runtime", 40, 1),
          _x("cudaMemcpy", "cuda_runtime", 55, 1),
          _x("aten::add", "cpu_op", 13, 2)]
    if with_spans:
        ev += [_x("stp/pairs", "user_annotation", 10, 40),
               _x("stp/sort", "user_annotation", 30, 15),
               _x("stp/blend", "user_annotation", 60, 30),
               _x("stp/blend_bwd", "user_annotation", 62, 8, tid=2),
               _x("stp/blend", "gpu_user_annotation", 70, 10, 7)]
    return ev


def test_reduce_by_hand():
    got = spans.reduce(_events(), 2, "frame")
    want = {  # per unit: the trace holds 2 units
        "stp/pairs": dict(busy_ms=32, self_busy_ms=20, launches=2,
                          idle_ms=10, self_idle_ms=10, syncs=1, host_ms=40,
                          count=1),
        "stp/sort": dict(busy_ms=17, self_busy_ms=17, launches=1, idle_ms=0,
                         self_idle_ms=0, syncs=1, host_ms=15, count=1),
        "stp/blend": dict(busy_ms=10, self_busy_ms=0, launches=1, idle_ms=20,
                          self_idle_ms=12, syncs=0, host_ms=30, count=1),
        "stp/blend_bwd": dict(busy_ms=10, self_busy_ms=10, launches=1,
                              idle_ms=8, self_idle_ms=8, syncs=0, host_ms=8,
                              count=1),
        spans.ANY: dict(busy_ms=42, self_busy_ms=42, launches=3, idle_ms=30,
                        self_idle_ms=30, syncs=1, host_ms=70, count=4),
    }
    assert set(got) == set(want)
    for name, keys in want.items():
        for k, v in keys.items():
            assert got[name][k] == pytest.approx(v / 2), (name, k)


def test_innermost_is_the_latest_start_on_any_thread():
    ev = _events()
    # The same kernel launched on thread 1 at 65: blend_bwd (thread 2) is
    # open and started after blend, so it is the innermost span.
    ev[4] = _launch(65, 3, tid=1)
    got = spans.reduce(ev, 1, "frame")
    assert got["stp/blend_bwd"]["self_busy_ms"] == pytest.approx(10)
    assert got["stp/blend"]["self_busy_ms"] == 0
    assert got["stp/blend"]["busy_ms"] == pytest.approx(10)


def test_idle_only_inside_the_marks():
    ev = [e for e in _events() if e["name"] != "frame"]
    ev.append(_x("frame", "user_annotation", 55, 30))  # [55, 85]
    got = spans.reduce(ev, 1, "frame")
    # idle inside [55, 85]: [55, 70] and [80, 85]; spans: blend from 60,
    # blend_bwd [62, 70].
    assert got["stp/blend"]["idle_ms"] == pytest.approx(2 + 8 + 5)
    assert got["stp/blend"]["self_idle_ms"] == pytest.approx(2 + 5)
    assert got["stp/blend_bwd"]["idle_ms"] == pytest.approx(8)
    assert got[spans.ANY]["idle_ms"] == pytest.approx(15)
    assert got["stp/pairs"]["idle_ms"] == 0


def test_summarize_is_unchanged_by_spans():
    found = []
    plain = trace.summarize(_events(), 0.2, 2, "frame")
    with breakdown.recording(found):
        with_spans = trace.summarize(_events(), 0.2, 2, "frame")
        without = trace.summarize(_events(False), 0.2, 2, "frame")
    assert "spans" not in plain
    assert with_spans == plain
    assert without == trace.summarize(_events(False), 0.2, 2, "frame")
    assert found == [spans.reduce(_events(), 2, "frame"), {}]
    assert set(found[0]) == {
        "stp/pairs", "stp/sort", "stp/blend", "stp/blend_bwd", spans.ANY}


def test_breakdown_prints_the_traced_segments_spans(monkeypatch, capsys):
    """``breakdown.main`` runs the cell traced and prints the reduction of
    the trace ``summarize`` saw last, after the run's own result line."""
    from harness import runner

    seen = []

    def fake_main(argv, t_start):
        seen.append(argv)
        trace.summarize(_events(False), 0.2, 2, "frame")
        trace.summarize(_events(), 0.2, 2, "frame")
        print(json.dumps({"correct": True}))
        return 0

    monkeypatch.setattr(runner, "main", fake_main)
    real = trace.summarize
    assert breakdown.main(["--workload", "w", "--seed", "1"], 0.0) == 0
    assert trace.summarize is real
    assert seen == [["--workload", "w", "--seed", "1", "--trace", "1"]]
    lines = capsys.readouterr().out.splitlines()
    assert json.loads(lines[0]) == {"correct": True}
    got = json.loads(lines[1])["spans"]
    assert got == json.loads(json.dumps(spans.reduce(_events(), 2, "frame")))

    monkeypatch.setattr(runner, "main", lambda argv, t_start: 3)
    assert breakdown.main([], 0.0) == 3
    assert capsys.readouterr().out == ""


def test_program_spans_in_a_cpu_trace(tmp_path):
    """A CPU-profiled render of the program: every view span once, no
    device work to put down to them."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from harness import common, scene
    from stopthepop_tpu_torch.render.cli import render_frames

    cfg = json.loads((ROOT / "portbench/configs/tandt-truck-global.json")
                     .read_text())
    cfg.update(gaussians=500, width=64, height=48)
    dev = torch.device("cpu")
    model = common.model(scene.make_scene(cfg, scene.generator(7, dev), dev))
    cam = scene.program_camera(scene.orbit_camera(0.3, cfg, 4.0, 0.5))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("frame"):
            render_frames(model, [cam], common.settings(cfg), dev,
                          tile_shape=common.tile_shape(cfg))
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    events = json.loads((tmp_path / "t.json").read_text())["traceEvents"]
    got = spans.reduce(events, 1, "frame")
    assert set(got) == {f"stp/{n}" for n in (
        "params", "preprocess", "pairs", "duplicate", "sort", "blend", "*")}
    assert all(v["count"] == 1 and v["busy_ms"] == 0 and v["host_ms"] > 0
               for k, v in got.items() if k != spans.ANY)
