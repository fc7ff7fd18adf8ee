"""The program's ``stp/`` spans (utils/profiling.py::span), on the CPU.

Under ``torch.profiler`` a render in each sort mode exports the view spans
in their order (params, preprocess, pairs holding duplicate and sort,
blend), and a GLOBAL and a HIER training step export forward holding loss,
backward holding blend_bwd, and update. With no profiler active ``span``
makes one check of the profiler and one of the listening timers, never
calls ``record_function``, and the render, gradients and Adam state are
bitwise those of a traced run.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import stopthepop_tpu_torch as stt
from stopthepop_tpu_torch.io.cameras import CameraArrays
from stopthepop_tpu_torch.models.gaussians import init_random
from stopthepop_tpu_torch.render.cli import render_model
from stopthepop_tpu_torch.train import trainer
from stopthepop_tpu_torch.utils import profiling
from stopthepop_tpu_torch.utils.testing import make_camera, one_thread_under_xdist

one_thread_under_xdist()

W, H = 48, 32
VIEW_SPANS = ("params", "preprocess", "pairs", "duplicate", "sort", "blend")
MODES = {"global": (stt.SortMode.GLOBAL, "auto"),
         "kbuffer": (stt.SortMode.PPX_KBUFFER, "auto"),
         "hier": (stt.SortMode.HIER, "auto"),
         "full_tiled": (stt.SortMode.PPX_FULL, "tiled")}


def _static(mode):
    ext = stt.ExtendedSettings()
    ext.sort_settings.sort_mode = mode
    ext.culling_settings.rect_bounding = True
    ext.culling_settings.tight_opacity_bounding = True
    cam = make_camera(W, H, device="cpu")
    static = stt.GaussianRasterizationSettings(
        image_height=H, image_width=W, tanfovx=cam.tanfovx,
        tanfovy=cam.tanfovy, bg=torch.tensor([0.1, 0.2, 0.3]),
        scale_modifier=1.0, viewmatrix=None, projmatrix=None,
        inv_viewprojmatrix=None, sh_degree=3, campos=None, prefiltered=False,
        settings=ext)
    arrays = CameraArrays(cam.viewmatrix, cam.projmatrix,
                          cam.inv_viewprojmatrix, cam.campos)
    return static, arrays


def _spans(fn, tmp_path):
    """{name: [(start, end), ...]} of the ``stp/`` ranges a profiled
    ``fn()`` records, in µs on the profiler's clock."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = {}
    for e in events:
        name = e.get("name", "")
        if e.get("ph") == "X" and name.startswith(profiling.SPAN_PREFIX):
            ts = float(e["ts"])
            out.setdefault(name[len(profiling.SPAN_PREFIX):], []).append(
                (ts, ts + float(e["dur"])))
    return out


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


@pytest.mark.parametrize("case", list(MODES))
def test_render_exports_the_view_spans(case, tmp_path):
    mode, full_mode = MODES[case]
    static, cam = _static(mode)
    model = init_random(60, seed=3, device="cpu")

    def render():
        with torch.no_grad():
            render_model(model, cam, static=static, full_output=True,
                         full_mode=full_mode)

    spans = _spans(render, tmp_path)
    assert set(spans) == set(VIEW_SPANS)
    assert all(len(v) == 1 for v in spans.values()), spans
    s = {k: v[0] for k, v in spans.items()}
    assert s["params"][1] <= s["preprocess"][0]
    assert s["preprocess"][1] <= s["pairs"][0]
    assert s["pairs"][1] <= s["blend"][0]
    assert _inside(s["duplicate"], s["pairs"])
    assert _inside(s["sort"], s["pairs"])
    assert s["duplicate"][1] <= s["sort"][0]


def _train_setup(mode, seed=4):
    static, cam = _static(mode)
    model = init_random(60, seed=seed, device="cpu")
    opt = trainer.make_3dgs_optimizer(model, 1.0)
    target = torch.from_numpy(np.random.default_rng(seed).uniform(
        0, 1, (3, H, W)).astype(np.float32))
    return static, cam, trainer.init_train_state(model, opt), target


@pytest.mark.parametrize("mode", [stt.SortMode.GLOBAL, stt.SortMode.HIER],
                         ids=["global", "hier"])
def test_train_step_exports_the_step_spans(mode, tmp_path):
    static, cam, state, target = _train_setup(mode)
    step = trainer.make_train_step(static=static)
    stats = trainer.init_densify_stats(60)
    spans = _spans(lambda: step(state, cam, target, stats), tmp_path)
    assert set(spans) == set(VIEW_SPANS) | {"forward", "loss", "backward",
                                            "blend_bwd", "update"}
    s = {k: v[0] for k, v in spans.items()}
    for inner in VIEW_SPANS + ("loss",):
        assert _inside(s[inner], s["forward"]), inner
    assert s["blend"][1] <= s["loss"][0]
    assert _inside(s["blend_bwd"], s["backward"])
    assert s["forward"][1] <= s["backward"][0] <= s["backward"][1] \
        <= s["update"][0]


def test_span_off_is_two_checks_and_a_shared_no_op(monkeypatch):
    calls = []

    def enabled():
        calls.append(1)
        return False

    monkeypatch.setattr(profiling, "_profiler_enabled", enabled)
    off = profiling.span("preprocess")
    assert off is profiling.span("blend") and len(calls) == 2
    with off:
        pass
    timer = profiling.StageTimer()
    with timer.listening():
        assert profiling.span("blend") is not off
    assert profiling.span("blend") is off


def _step_outputs(mode):
    """Colour, gradients and Adam state of one GLOBAL or HIER step taken
    through the trainer's three stages."""
    static, cam, state, target = _train_setup(mode, seed=5)
    loss, out, _ = trainer.step_forward(state, cam, target, static=static)
    trainer.step_backward(state, loss)
    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    grads = [p.grad.clone() for p in params]
    trainer.step_update(state)
    adam = [t.clone() for p in params
            for t in state.optimizer.state[p].values()]
    return [out.color.detach()] + grads + adam + [p.detach() for p in params]


@pytest.mark.parametrize("mode", [stt.SortMode.GLOBAL, stt.SortMode.HIER],
                         ids=["global", "hier"])
def test_untraced_step_never_records_and_matches_traced(mode, monkeypatch):
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _step_outputs(mode)

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(profiling, "record_function", refuse)
    plain = _step_outputs(mode)
    assert len(plain) == len(traced)
    for a, b in zip(plain, traced):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
