"""The port's stage timer, timed GLOBAL path, profiler trace and debug
snapshots, on the CPU.

``render_tiled_timed``, and a render in each other sort mode inside
``StageTimer.listening``, are held bitwise against the untimed render, and
the timings text names the reference's four stages after ``interval``
frames (as tests/test_profiling.py does for the JAX package). ``debug=True``: a
forward that raises writes a ``snapshot_fw`` holding the inputs and
re-raises; a blend backward that raises writes a ``snapshot_bw``; a render
that succeeds is bitwise the render without it.
"""

import json
import os

import numpy as np
import pytest
import torch

import stopthepop_tpu_torch as stt
from stopthepop_tpu_torch.kernels import global_blend, hier_blend
from stopthepop_tpu_torch.render.pipeline import render_tiled, render_tiled_timed
from stopthepop_tpu_torch.render.preprocess import preprocess
from stopthepop_tpu_torch.utils.profiling import STAGES, StageTimer, trace
from stopthepop_tpu_torch.utils.snapshot import load_snapshot
from stopthepop_tpu_torch.utils.testing import (
    make_camera,
    one_thread_under_xdist,
    random_scene,
)

one_thread_under_xdist()

W = H = 48
BG = torch.tensor([0.1, 0.2, 0.3])


def _prep_fn(scene, cam):
    def prep_fn():
        return preprocess(
            scene.means3d, scene.opacities, scales=scene.scales,
            rotations=scene.rotations, shs=scene.shs,
            viewmatrix=cam.viewmatrix, projmatrix=cam.projmatrix,
            campos=cam.campos, tanfovx=cam.tanfovx, tanfovy=cam.tanfovy,
            image_width=W, image_height=H, sh_degree=3)
    return prep_fn


def _global_timed(timer):
    """(timed, untimed) GLOBAL renders through ``render_tiled_timed``."""
    cam = make_camera(W, H, device="cpu")
    prep_fn = _prep_fn(random_scene(2, 100, device="cpu"), cam)
    timed = render_tiled_timed(prep_fn, timer, BG, image_width=W,
                               image_height=H)
    untimed = render_tiled(prep_fn(), BG, image_width=W, image_height=H)
    assert torch.equal(timed[3].gauss_id, untimed[3].gauss_id)
    return timed[:3] + timed[4:], untimed[:3] + untimed[4:]


def _listening(mode, full_mode):
    def render(timer):
        """(timed, untimed) renders of ``mode`` through the API, the timed
        one inside ``timer.listening()``."""
        cam = make_camera(W, H, device="cpu")
        scene = random_scene(2, 100, device="cpu")
        rs = _settings(cam)
        rs.settings.sort_settings.sort_mode = mode
        raster = stt.GaussianRasterizer(rs, full_output=True,
                                        full_mode=full_mode)
        with torch.no_grad():
            with timer.listening():
                timed = raster(**_inputs(scene))
            timer.frame()
            untimed = raster(**_inputs(scene))
        return timed, untimed
    return render


TIMED = {"global": _global_timed,
         "kbuffer": _listening(stt.SortMode.PPX_KBUFFER, "auto"),
         "hier": _listening(stt.SortMode.HIER, "auto"),
         "full_tiled": _listening(stt.SortMode.PPX_FULL, "tiled")}


@pytest.mark.parametrize("case", list(TIMED))
def test_timed_render_matches_untimed(case):
    timer = StageTimer(interval=2)
    for frame in range(2):
        assert timer.timings_text == ""
        timed, untimed = TIMED[case](timer)
    for a, b in zip(timed, untimed):
        if isinstance(a, torch.Tensor):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        else:
            assert a == b
    lines = timer.timings_text.splitlines()
    assert [ln.split(":")[0] for ln in lines] == list(STAGES)
    assert all(float(ln.split()[1]) >= 0.0 for ln in lines)
    assert timer.report() == ""  # the accumulator restarts after the interval


def test_stage_timer_interval_and_disabled():
    timer = StageTimer(interval=2)
    for _ in range(2):
        assert timer.time("Render", torch.ones, 4).sum() == 4
        with timer.stage("Blend"):
            pass
        timer.frame()
    assert timer.timings_text.splitlines()[0].startswith("Render: ")
    assert "Blend" in timer.timings_text
    off = StageTimer(enabled=False, interval=1)
    off.time("Render", torch.ones, 4)
    off.frame()
    assert off.timings_text == "" and off.report() == ""


def test_trace_writes_a_chrome_trace(tmp_path):
    cam = make_camera(W, H, device="cpu")
    prep_fn = _prep_fn(random_scene(2, 50, device="cpu"), cam)
    with trace(str(tmp_path / "tb")):
        render_tiled(prep_fn(), BG, image_width=W, image_height=H)
    with open(tmp_path / "tb" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("cumsum" in e.get("name", "") for e in events)


def _settings(cam, **kw):
    ext = stt.ExtendedSettings()
    return stt.GaussianRasterizationSettings(
        image_height=H, image_width=W, tanfovx=cam.tanfovx,
        tanfovy=cam.tanfovy, bg=BG, scale_modifier=1.0,
        viewmatrix=cam.viewmatrix, projmatrix=cam.projmatrix,
        inv_viewprojmatrix=cam.inv_viewprojmatrix, sh_degree=3,
        campos=cam.campos, prefiltered=False, settings=ext, **kw)


def _inputs(scene, **over):
    kw = dict(means3D=scene.means3d, means2D=None, opacities=scene.opacities,
              shs=scene.shs, scales=scene.scales, rotations=scene.rotations)
    kw.update(over)
    return kw


def test_debug_forward_failure_writes_snapshot_fw(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("STP_SNAPSHOT_DIR", str(tmp_path))
    cam = make_camera(W, H, device="cpu")
    scene = random_scene(3, 40, device="cpu")
    bad = torch.cat([scene.opacities, scene.opacities[:1]])  # one too many
    inputs = _inputs(scene, opacities=bad)
    with pytest.raises(RuntimeError):
        stt.GaussianRasterizer(_settings(cam, debug=True))(**inputs)
    assert "snapshot_fw.npz" in capsys.readouterr().out
    snap = load_snapshot(str(tmp_path / "snapshot_fw.npz"))
    for ours, key in (("means3D", "means3D"), ("opacities", "opacities"),
                      ("shs", "sh"), ("scales", "scales"),
                      ("rotations", "rotations")):
        np.testing.assert_array_equal(snap[key], inputs[ours].numpy())
    np.testing.assert_array_equal(snap["viewmatrix"], cam.viewmatrix.numpy())
    assert "means2D" not in snap and "colors_precomp" not in snap
    with open(tmp_path / "snapshot_fw.json") as f:
        meta = json.load(f)
    assert meta["image_width"] == W and "sort_settings" in meta["settings"]
    assert not os.path.exists(tmp_path / "snapshot_bw.npz")


@pytest.mark.parametrize("mode", [stt.SortMode.GLOBAL, stt.SortMode.HIER],
                         ids=["global", "hier"])
def test_debug_backward_failure_writes_snapshot_bw(mode, tmp_path,
                                                   monkeypatch):
    monkeypatch.setenv("STP_SNAPSHOT_DIR", str(tmp_path))
    module, name = {
        stt.SortMode.GLOBAL: (global_blend, "blend_global_backward"),
        stt.SortMode.HIER: (hier_blend, "blend_hier_backward")}[mode]

    def fail(*args, **kw):
        raise RuntimeError("injected backward fault")

    monkeypatch.setattr(module, name, fail)
    cam = make_camera(W, H, device="cpu")
    scene = random_scene(3, 40, device="cpu")
    means = scene.means3d.clone().requires_grad_(True)
    rs = _settings(cam, debug=True)
    rs.settings.sort_settings.sort_mode = mode
    color, _ = stt.GaussianRasterizer(rs)(**_inputs(scene, means3D=means))
    with pytest.raises(RuntimeError, match="injected backward fault"):
        color.sum().backward()
    snap = load_snapshot(str(tmp_path / "snapshot_bw.npz"))
    np.testing.assert_array_equal(snap["means3D"], scene.means3d.numpy())
    np.testing.assert_array_equal(snap["grad_color"], np.ones((3, H, W),
                                                              np.float32))
    assert snap["grad_final_t"].shape == (H, W)
    assert os.path.exists(tmp_path / "snapshot_bw.json")


def test_debug_render_that_succeeds_is_the_plain_render(tmp_path, monkeypatch):
    monkeypatch.setenv("STP_SNAPSHOT_DIR", str(tmp_path))
    cam = make_camera(W, H, device="cpu")
    scene = random_scene(4, 60, device="cpu")
    outs = []
    for debug in (False, True):
        means = scene.means3d.clone().requires_grad_(True)
        out = stt.GaussianRasterizer(_settings(cam, debug=debug),
                                     full_output=True)(
            **_inputs(scene, means3D=means))
        out.color.sum().backward()
        outs.append((out, means.grad))
    (plain, g_plain), (dbg, g_dbg) = outs
    for a, b in zip(plain[:5], dbg[:5]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(g_plain, g_dbg, rtol=0, atol=0)
    assert not os.listdir(tmp_path)
