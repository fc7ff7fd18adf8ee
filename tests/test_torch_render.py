"""The port's public API, model, IO and CLI against the JAX package, on the CPU.

``GaussianRasterizer`` and the render CLI's frame loop are held call for call
against the JAX package's, with the JAX model's weights carried across by
``from_numpy_params``: color and final_T within atol 1e-4 (see
test_torch_blend.py for why), radii exactly, n_contrib on >= 99.9% of the
pixels. Also: PLY interchange, validation errors, that the paths ported
since the first slice run where they once raised NotImplementedError, and
that the port never loads JAX.
"""

import ast
import math
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stopthepop_tpu
from stopthepop_tpu.io.cameras import orbit_camera as jax_orbit_camera
from stopthepop_tpu.io.cameras import to_camera_arrays as jax_to_camera_arrays
from stopthepop_tpu.io.images import read_png
from stopthepop_tpu.io.ply import load_gaussian_model as jax_load_model
from stopthepop_tpu.io.ply import save_gaussian_model as jax_save_model
from stopthepop_tpu.models.gaussians import GaussianModel as JaxModel
from stopthepop_tpu.models.gaussians import init_random as jax_init_random
from stopthepop_tpu.train.trainer import render_model as jax_render_model

import stopthepop_tpu_torch as stt
from stopthepop_tpu_torch.io.cameras import orbit_camera, to_camera_arrays
from stopthepop_tpu_torch.io.images import write_png
from stopthepop_tpu_torch.io.ply import load_gaussian_model, save_gaussian_model
from stopthepop_tpu_torch.models.gaussians import (
    from_numpy_params,
    init_random,
    to_numpy_params,
)
from stopthepop_tpu_torch.render import cli
from stopthepop_tpu_torch.utils.testing import (
    make_camera,
    one_thread_under_xdist,
    random_scene,
)

one_thread_under_xdist()

PORT = Path(stt.__file__).resolve().parent
BG = np.array([0.1, 0.2, 0.3], np.float32)


def _jax_model(n=200, seed=0):
    m = jax_init_random(jax.random.PRNGKey(seed), n, extent=1.5)
    return m, {k: np.asarray(v) for k, v in m._asdict().items()}


def _ext(mod, order=0, cull=True, ewa=False):
    ext = mod.ExtendedSettings()
    ext.sort_settings.sort_order = mod.GlobalSortOrder(order)
    ext.culling_settings.rect_bounding = cull
    ext.culling_settings.tight_opacity_bounding = cull
    ext.proper_ewa_scaling = ewa
    return ext


def _settings(mod, cam, w, h, ext, as_array):
    return mod.GaussianRasterizationSettings(
        image_height=h, image_width=w, tanfovx=cam.tanfovx, tanfovy=cam.tanfovy,
        bg=as_array(BG), scale_modifier=1.0,
        viewmatrix=as_array(cam.viewmatrix), projmatrix=as_array(cam.projmatrix),
        inv_viewprojmatrix=as_array(cam.inv_viewprojmatrix), sh_degree=3,
        campos=as_array(cam.campos), prefiltered=False, settings=ext,
    )


def _assert_render_close(t, j):
    np.testing.assert_allclose(t.color.numpy(), np.asarray(j.color), atol=1e-4, rtol=0)
    np.testing.assert_allclose(t.final_t.numpy(), np.asarray(j.final_t), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(t.radii.numpy(), np.asarray(j.radii))
    assert (t.n_contrib.numpy() == np.asarray(j.n_contrib)).mean() >= 0.999


@pytest.mark.parametrize(
    "order,cull,ewa", [(0, True, False), (1, False, False), (0, False, True)],
    ids=["zdepth-cull", "distance", "zdepth-ewa"],
)
def test_rasterizer_matches_jax_call_for_call(order, cull, ewa):
    w, h = 72, 40
    jmodel, params = _jax_model()
    model = from_numpy_params(params, device="cpu")
    cam = make_camera(w, h, device="cpu")
    to_np = lambda x: x.numpy() if isinstance(x, torch.Tensor) else x  # noqa: E731
    rs = _settings(stt, cam, w, h, _ext(stt, order, cull, ewa), torch.as_tensor)
    jrs = _settings(stopthepop_tpu, cam, w, h,
                    _ext(stopthepop_tpu, order, cull, ewa),
                    lambda x: jnp.asarray(to_np(x)))
    with torch.inference_mode():
        color, radii = stt.GaussianRasterizer(rs)(
            model.means3d, torch.zeros_like(model.means3d), model.opacities(),
            shs=model.shs(), scales=model.scales(),
            rotations=model.rotations_normalized(),
        )
        out = stt.GaussianRasterizer(rs, full_output=True)(
            model.means3d, None, model.opacities(), shs=model.shs(),
            scales=model.scales(), rotations=model.rotations_normalized(),
        )
    jout = stopthepop_tpu.GaussianRasterizer(jrs, full_output=True)(
        jmodel.means3d, None, jmodel.opacities(), shs=jmodel.shs(),
        scales=jmodel.scales(), rotations=jmodel.rotations_normalized(),
    )
    torch.testing.assert_close(color, out.color, rtol=0, atol=0)
    torch.testing.assert_close(radii, out.radii, rtol=0, atol=0)
    _assert_render_close(out, jout)
    assert out.num_rendered > 0


@pytest.mark.parametrize("order,cull", [(2, False), (3, True)],
                         ids=["ptd_center", "ptd_max-cull"])
def test_global_per_tile_depth_orders_match_jax(order, cull):
    w, h = 72, 40
    jmodel, params = _jax_model(seed=2)
    model = from_numpy_params(params, device="cpu")
    cam = make_camera(w, h, device="cpu")
    to_np = lambda x: x.numpy() if isinstance(x, torch.Tensor) else x  # noqa: E731
    ext, jext = _ext(stt, order, cull), _ext(stopthepop_tpu, order, cull)
    ext.culling_settings.tile_based_culling = cull
    jext.culling_settings.tile_based_culling = cull
    rs = _settings(stt, cam, w, h, ext, torch.as_tensor)
    jrs = _settings(stopthepop_tpu, cam, w, h, jext, lambda x: jnp.asarray(to_np(x)))
    with torch.inference_mode():
        out = stt.GaussianRasterizer(rs, full_output=True)(
            model.means3d, None, model.opacities(), shs=model.shs(),
            scales=model.scales(), rotations=model.rotations_normalized())
    jout = stopthepop_tpu.GaussianRasterizer(jrs, full_output=True)(
        jmodel.means3d, None, jmodel.opacities(), shs=jmodel.shs(),
        scales=jmodel.scales(), rotations=jmodel.rotations_normalized())
    _assert_render_close(out, jout)
    assert out.num_rendered > 0


def test_render_frames_matches_jax_render_model():
    w, h, frames = 48, 32, 2
    jmodel, params = _jax_model(seed=1)
    model = from_numpy_params(params, device="cpu")
    ext = _ext(stt)
    cams = [orbit_camera(2 * math.pi * i / frames, math.radians(60), w, h)
            for i in range(frames)]
    outs = cli.render_frames(model, cams, ext, "cpu", bg=tuple(BG))
    assert len(outs) == frames
    for i, out in enumerate(outs):
        jcam = jax_orbit_camera(2 * math.pi * i / frames, math.radians(60), w, h)
        np.testing.assert_array_equal(cams[i].projmatrix, jcam.projmatrix)
        jrs = _settings(stopthepop_tpu, jcam, w, h, _ext(stopthepop_tpu), jnp.asarray)
        jout = jax_render_model(jmodel, jax_to_camera_arrays(jcam), static=jrs,
                                full_output=True)
        _assert_render_close(out, jout)


def test_model_weights_round_trip_and_activations():
    jmodel, params = _jax_model(n=30)
    model = from_numpy_params(params, device="cpu")
    back = to_numpy_params(model)
    assert back.keys() == params.keys()
    for k in params:
        np.testing.assert_array_equal(back[k], params[k])
    for name in ("scales", "opacities", "rotations_normalized", "shs"):
        np.testing.assert_allclose(getattr(model, name)().detach().numpy(),
                                   np.asarray(getattr(jmodel, name)()),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    assert model.sh_degree == 3 and model.num_gaussians == 30
    rnd = init_random(40, seed=3, sh_degree=2, device="cpu")
    assert rnd.shs().shape == (40, 9, 3) and rnd.sh_degree == 2
    assert rnd.means3d.dtype == torch.float32
    again = init_random(40, seed=3, sh_degree=2, device="cpu")
    torch.testing.assert_close(rnd.sh_rest, again.sh_rest, rtol=0, atol=0)


def test_ply_interchange_with_jax(tmp_path):
    jmodel, params = _jax_model(n=25)
    jax_save_model(str(tmp_path / "jax.ply"), jmodel)
    model = load_gaussian_model(str(tmp_path / "jax.ply"), device="cpu")
    for k, v in to_numpy_params(model).items():
        np.testing.assert_array_equal(v, params[k], err_msg=k)
    save_gaussian_model(str(tmp_path / "port.ply"), model)
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
    back = jax_load_model(str(tmp_path / "port.ply"))
    assert isinstance(back, JaxModel)
    for k, v in back._asdict().items():
        np.testing.assert_array_equal(np.asarray(v), params[k], err_msg=k)


def test_cli_writes_frames(tmp_path):
    _, params = _jax_model(n=60)
    save_gaussian_model(str(tmp_path / "m.ply"), from_numpy_params(params, "cpu"))
    cli.main(["--ply", str(tmp_path / "m.ply"), "--out", str(tmp_path / "frames"),
              "--frames", "2", "--width", "40", "--height", "24",
              "--device", "cpu"])
    for i in range(2):
        img = read_png(str(tmp_path / "frames" / f"frame_{i:04d}.png"))
        assert img.shape == (24, 40, 3) and img.max() > 0


def test_cli_writes_kbuffer_frames(tmp_path):
    _, params = _jax_model(n=60)
    save_gaussian_model(str(tmp_path / "m.ply"), from_numpy_params(params, "cpu"))
    cli.main(["--ply", str(tmp_path / "m.ply"), "--out", str(tmp_path / "frames"),
              "--frames", "1", "--width", "40", "--height", "24",
              "--sort-mode", "PPX_KBUFFER", "--device", "cpu"])
    img = read_png(str(tmp_path / "frames" / "frame_0000.png"))
    assert img.shape == (24, 40, 3) and img.max() > 0


def test_write_png_reads_back(tmp_path):
    img = (np.arange(6 * 5 * 3) % 256).astype(np.uint8).reshape(6, 5, 3)
    write_png(str(tmp_path / "a.png"), img)
    np.testing.assert_array_equal(read_png(str(tmp_path / "a.png")), img)
    with pytest.raises(ValueError):
        write_png(str(tmp_path / "b.png"), img.astype(np.float32))


def _scene_args(n=40):
    scene = random_scene(0, n, device="cpu")
    cam = make_camera(32, 32, device="cpu")
    rs = _settings(stt, cam, 32, 32, _ext(stt), torch.as_tensor)
    return scene, rs


def test_validation_messages_match_reference():
    scene, rs = _scene_args()
    r = stt.GaussianRasterizer(rs)
    with pytest.raises(Exception, match="excatly one of either SHs"):
        r(scene.means3d, None, scene.opacities, scales=scene.scales,
          rotations=scene.rotations)
    with pytest.raises(Exception, match="excatly one of either SHs"):
        r(scene.means3d, None, scene.opacities, shs=scene.shs,
          colors_precomp=scene.colors, scales=scene.scales,
          rotations=scene.rotations)
    with pytest.raises(Exception, match="scale/rotation pair"):
        r(scene.means3d, None, scene.opacities, shs=scene.shs,
          scales=scene.scales)
    with pytest.raises(Exception, match="scale/rotation pair"):
        r(scene.means3d, None, scene.opacities, shs=scene.shs,
          scales=scene.scales, rotations=scene.rotations,
          cov3D_precomp=torch.zeros(40, 6))
    means = scene.means3d.clone()
    means[0, 2] = -10.0
    with pytest.raises(RuntimeError, match="prefiltered"):
        stt.GaussianRasterizer(rs._replace(prefiltered=True))(
            means, None, scene.opacities, colors_precomp=scene.colors,
            scales=scene.scales, rotations=scene.rotations)
    vis = r.markVisible(means)
    assert vis.dtype == torch.bool and not vis[0] and vis[1:].all()


def test_forward_only_slice_raises_not_implemented():
    scene, rs = _scene_args()
    kw = dict(colors_precomp=scene.colors, scales=scene.scales,
              rotations=scene.rotations)
    def settings_with(**changes):
        ext = _ext(stt)
        for k, v in changes.items():
            ext.set_value(k, v)
        return rs._replace(settings=ext)

    # Gradients (kernel K2) and tile_based_culling are ported now: the same
    # calls return finite gradients.
    for s in (rs, settings_with(tile_based_culling=True)):
        means = scene.means3d.clone().requires_grad_(True)
        color, _ = stt.GaussianRasterizer(s)(means, None, scene.opacities, **kw)
        color.sum().backward()
        assert torch.isfinite(color).all()
        assert torch.isfinite(means.grad).all() and means.grad.abs().sum() > 0
    with torch.no_grad():
        color, _ = stt.GaussianRasterizer(rs)(means, None, scene.opacities, **kw)
    assert torch.isfinite(color).all()

    # The k-buffer sort mode (kernels K3/K4), the per-tile-depth stream
    # orders and the HIER forward (kernel K5) are ported now: the same calls
    # render finite images.
    hier = settings_with(sort_mode=stt.SortMode.HIER)
    for s in [settings_with(sort_mode=stt.SortMode.PPX_KBUFFER), hier] + [
            settings_with(sort_order=o) for o in (stt.GlobalSortOrder.PTD_CENTER,
                                                  stt.GlobalSortOrder.PTD_MAX)]:
        with torch.no_grad():
            color, _ = stt.GaussianRasterizer(s)(scene.means3d, None,
                                                 scene.opacities, **kw)
        assert torch.isfinite(color).all()
        assert (color != torch.as_tensor(BG)[:, None, None]).any()
    # So is HIER's backward (kernel K6): with gradients it returns them.
    means = scene.means3d.clone().requires_grad_(True)
    color, _ = stt.GaussianRasterizer(hier)(means, None, scene.opacities, **kw)
    color.sum().backward()
    assert torch.isfinite(means.grad).all() and (means.grad != 0).any()

    # So is PER_PIXEL_FULL (kernel K7; this small scene takes the dense
    # oracle): it renders a finite image.
    with torch.no_grad():
        color, _ = stt.GaussianRasterizer(
            settings_with(sort_mode=stt.SortMode.PPX_FULL))(
                scene.means3d, None, scene.opacities, **kw)
    assert torch.isfinite(color).all()
    assert (color != torch.as_tensor(BG)[:, None, None]).any()

    # So are render_depth (the Depth debug visualization: a turbo-coloured
    # image in [0, 1], not the colour) and debug=True (failure snapshots: a
    # render that succeeds is bitwise the plain one).
    with torch.no_grad():
        plain, _ = stt.GaussianRasterizer(rs)(scene.means3d, None,
                                              scene.opacities, **kw)
        depth, _ = stt.GaussianRasterizer(rs._replace(render_depth=True))(
            scene.means3d, None, scene.opacities, **kw)
        debug, _ = stt.GaussianRasterizer(rs._replace(debug=True))(
            scene.means3d, None, scene.opacities, **kw)
    assert torch.isfinite(depth).all() and not torch.equal(depth, plain)
    assert float(depth.min()) >= 0.0 and float(depth.max()) <= 1.0
    torch.testing.assert_close(debug, plain, rtol=0, atol=0)


def test_entry_points_need_a_gpu_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_camera(16, 16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_random(4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        to_camera_arrays(orbit_camera(0.0, 1.0, 16, 16))
    assert make_camera(16, 16, device="cpu").viewmatrix.device.type == "cpu"


def test_import_leaves_jax_unloaded():
    code = ("import sys, stopthepop_tpu_torch, stopthepop_tpu_torch.render.cli, "
            "stopthepop_tpu_torch.train.cli, stopthepop_tpu_torch.parallel, "
            "stopthepop_tpu_torch.parallel.collectives, "
            "stopthepop_tpu_torch.parallel.hosts, "
            "stopthepop_tpu_torch.parallel.train, "
            "stopthepop_tpu_torch.parallel.spatial, "
            "stopthepop_tpu_torch.parallel.ring; "
            "assert 'jax' not in sys.modules, 'jax loaded'; "
            "assert not any(m.split('.')[0] == 'stopthepop_tpu' for m in sys.modules)")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=PORT.parent, timeout=120)


def test_no_port_file_imports_jax_or_the_jax_package():
    offenders = []
    files = sorted(PORT.rglob("*.py")) + [PORT.parent / "chip_smoke.py"]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in ("jax", "jaxlib", "stopthepop_tpu"):
                    offenders.append(f"{path.name}: {name}")
    assert len(files) > 20 and not offenders, offenders
