"""The port's debug visualization (render/debug_viz.py, through
``GaussianRasterizer``) against the JAX package's, on the CPU.

Every mode in GLOBAL, PPX_KBUFFER and PPX_FULL goes through both packages'
``rasterize_gaussians(..., debug_visualization=mode, debug_data=data)`` on
the same numpy-drawn scene with the JAX model's weights. The scalar fields
agree at the image tolerances of PERF.md §2 (1e-4 GLOBAL, 3e-5 k-buffer,
1e-5 FULL) times the larger of 1 and the field's largest value (a depth or
a count runs to ~10), counts exactly; the coloured images on at least 99.9%
of the pixels (a value within rounding of a bin edge may fall in the next
bin); the statistics and the probe value of ``DebugVisualizationData`` at
the field tolerance, and its callback is called once a render.

The JAX k-buffer and HIER Depth images are NaN-based: their Pallas kernels
add w * d0 also where a step pops nothing (w = 0, d0 = +inf from an empty
slot), so their depth_acc is NaN (ROADMAP Queue 3). The port's k-buffer and
HIER Depth images are held against their own depth_acc / (1 - T) instead;
test_torch_hier.py holds HIER's depth_acc against a per-pixel cascade, and
here the k-buffer's, with a window of 24 that no pixel's stream fills, is
held against the JAX FULL oracle's Depth field (the same blend order then).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stopthepop_tpu
from stopthepop_tpu.models.gaussians import init_random as jax_init_random
from stopthepop_tpu.render.debug_viz import (
    DebugVisualizationData as JData,
)

import stopthepop_tpu_torch as stt
from stopthepop_tpu_torch.config import DebugVisualization, SortMode
from stopthepop_tpu_torch.models.gaussians import from_numpy_params
from stopthepop_tpu_torch.render import colormaps
from stopthepop_tpu_torch.render.debug_viz import (
    DebugVisualizationData,
    apply_colormap,
    debug_field,
    normalize_field,
)
from stopthepop_tpu_torch.utils.testing import make_camera, one_thread_under_xdist

one_thread_under_xdist()

SIZE = 32
BG = np.array([0.1, 0.2, 0.3], np.float32)
PROBE = (13, 17)
TOL = {SortMode.GLOBAL: 1e-4, SortMode.PPX_KBUFFER: 3e-5,
       SortMode.PPX_FULL: 1e-5}
MODES = [m for m in DebugVisualization if m != DebugVisualization.Disabled]
COUNTS = (DebugVisualization.GaussianCountPerPixel,
          DebugVisualization.GaussianCountPerTile)


def _model(n=80, seed=2):
    m = jax_init_random(jax.random.PRNGKey(seed), n, extent=1.2)
    params = {k: np.asarray(v) for k, v in m._asdict().items()}
    return m, from_numpy_params(params, device="cpu")


def _settings(mod, cam, mode, as_array, **kw):
    ext = mod.ExtendedSettings()
    ext.sort_settings.sort_mode = mod.SortMode(int(mode))
    return mod.GaussianRasterizationSettings(
        image_height=SIZE, image_width=SIZE, tanfovx=cam.tanfovx,
        tanfovy=cam.tanfovy, bg=as_array(BG), scale_modifier=1.0,
        viewmatrix=as_array(cam.viewmatrix), projmatrix=as_array(cam.projmatrix),
        inv_viewprojmatrix=as_array(cam.inv_viewprojmatrix), sh_degree=3,
        campos=as_array(cam.campos), prefiltered=False, settings=ext, **kw)


def _render(model, rs, **kw):
    return stt.GaussianRasterizer(rs, **kw)(
        model.means3d, None, model.opacities(), shs=model.shs(),
        scales=model.scales(), rotations=model.rotations_normalized())


def _jrender(jmodel, jrs, **kw):
    return stopthepop_tpu.GaussianRasterizer(jrs, **kw)(
        jmodel.means3d, None, jmodel.opacities(), shs=jmodel.shs(),
        scales=jmodel.scales(), rotations=jmodel.rotations_normalized())


def _stats(data):
    return np.array([data.minimum, data.maximum, data.mean, data.std,
                     data.debug_pixel_value])


@pytest.mark.parametrize("sort_mode", [SortMode.GLOBAL, SortMode.PPX_KBUFFER,
                                       SortMode.PPX_FULL],
                         ids=["global", "kbuffer", "full"])
def test_every_mode_matches_jax(sort_mode):
    jmodel, model = _model()
    cam = make_camera(SIZE, SIZE, device="cpu")
    rs = _settings(stt, cam, sort_mode, torch.as_tensor)
    jrs = _settings(stopthepop_tpu, cam, sort_mode,
                    lambda x: jnp.asarray(np.asarray(x)))
    tol = TOL[sort_mode]
    seen = set()
    modes = [m for m in MODES if sort_mode != SortMode.PPX_KBUFFER
             or m != DebugVisualization.Depth]
    for mode in modes:
        calls = []
        data = DebugVisualizationData(debug_pixel=PROBE,
                                      data_callback=calls.append)
        jdata = JData(debug_pixel=PROBE)
        # The JAX dense FULL oracle builds no pair list, so its
        # GaussianCountPerTile needs the tiled FULL path; the port's dense
        # path counts the pairs its rects imply, the same numbers here.
        jkw = ({"full_mode": "tiled"} if sort_mode == SortMode.PPX_FULL
               and mode == DebugVisualization.GaussianCountPerTile else {})
        with torch.no_grad():
            out = _render(model, rs, full_output=True,
                          debug_visualization=mode, debug_data=data)
        jout = _jrender(jmodel, jrs, full_output=True, debug_visualization=mode,
                        debug_data=jdata, **jkw)
        assert calls == [data], mode
        img, jimg = out.color.numpy(), np.asarray(jout.color)
        assert np.isfinite(img).all() and img.shape == (3, SIZE, SIZE), mode
        same = (img == jimg).all(axis=0).mean()
        assert same >= 0.999, f"{mode}: {same:.4f} of the pixels agree"
        seen.add(float(img.sum()))
        got, ref = _stats(data), _stats(jdata)
        if mode in COUNTS:
            np.testing.assert_array_equal(got[[0, 1, 4]], ref[[0, 1, 4]],
                                          err_msg=str(mode))
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=tol * max(1.0, np.abs(ref).max()),
                                   err_msg=str(mode))
        # The field itself, where the JAX render returns what it reads.
        jt = np.asarray(jout.final_t)
        jfield = {
            DebugVisualization.Depth: lambda: np.asarray(jout.depth_acc)
            / np.maximum(1.0 - jt, 1e-6),
            DebugVisualization.Transmittance: lambda: jt,
            DebugVisualization.GaussianCountPerPixel:
                lambda: np.asarray(jout.n_contrib).astype(np.float32),
        }.get(mode)
        if jfield is None:
            continue
        jfield = jfield()
        field = debug_field(mode, final_t=out.final_t, n_contrib=out.n_contrib,
                            depth_acc=out.depth_acc)[0].numpy()
        if mode in COUNTS:
            assert (field == jfield).mean() >= 0.999, mode
        else:
            np.testing.assert_allclose(
                field, jfield, rtol=0,
                atol=tol * max(1.0, np.abs(jfield).max()), err_msg=str(mode))
    assert len(seen) == len(modes)  # every mode renders something distinct


@pytest.mark.parametrize("sort_mode", [SortMode.PPX_KBUFFER, SortMode.HIER],
                         ids=["kbuffer", "hier"])
def test_resort_depth_is_its_own_depth_acc_over_coverage(sort_mode):
    _, model = _model()
    cam = make_camera(SIZE, SIZE, device="cpu")
    rs = _settings(stt, cam, sort_mode, torch.as_tensor)
    data = DebugVisualizationData(debug_pixel=PROBE)
    with torch.no_grad():
        plain = _render(model, rs, full_output=True)
        out = _render(model, rs, full_output=True,
                      debug_visualization=DebugVisualization.Depth,
                      debug_data=data)
    field = plain.depth_acc / torch.clamp(1.0 - plain.final_t, min=1e-6)
    assert torch.isfinite(field).all() and float(field.max()) > 1.0
    lo, hi = field.min(), field.max()
    torch.testing.assert_close(
        out.color, apply_colormap(normalize_field(field, lo, hi),
                                  colormaps.TURBO_TABLE), rtol=0, atol=0)
    assert data.maximum == float(hi) and data.minimum == float(lo)
    assert data.debug_pixel_value == float(field[PROBE[1], PROBE[0]])


def test_kbuffer_depth_matches_jax_full_when_no_window_overflows():
    jmodel, model = _model()
    cam = make_camera(SIZE, SIZE, device="cpu")
    rs = _settings(stt, cam, SortMode.PPX_KBUFFER, torch.as_tensor)
    rs.settings.sort_settings.queue_sizes.per_pixel = 24
    jrs = _settings(stopthepop_tpu, cam, SortMode.PPX_FULL,
                    lambda x: jnp.asarray(np.asarray(x)))
    with torch.no_grad():
        out = _render(model, rs, full_output=True)
    jout = _jrender(jmodel, jrs, full_output=True)
    assert 4 < int(out.n_contrib.max()) < 24
    field = debug_field(DebugVisualization.Depth, final_t=out.final_t,
                        n_contrib=out.n_contrib, depth_acc=out.depth_acc)[0]
    jfield = np.asarray(jout.depth_acc) / np.maximum(
        1.0 - np.asarray(jout.final_t), 1e-6)
    np.testing.assert_allclose(
        field.numpy(), jfield, rtol=0,
        atol=TOL[SortMode.PPX_KBUFFER] * max(1.0, np.abs(jfield).max()))


@pytest.mark.parametrize("sort_mode", [SortMode.GLOBAL, SortMode.HIER],
                         ids=["global", "hier"])
def test_render_depth_is_the_depth_mode(sort_mode):
    _, model = _model()
    cam = make_camera(SIZE, SIZE, device="cpu")
    rs = _settings(stt, cam, sort_mode, torch.as_tensor)
    with torch.no_grad():
        depth, _ = _render(model, rs._replace(render_depth=True))
        viz, _ = _render(model, rs,
                         debug_visualization=DebugVisualization.Depth)
        color, _ = _render(model, rs)
    torch.testing.assert_close(depth, viz, rtol=0, atol=0)
    assert not torch.equal(depth, color)


@pytest.mark.parametrize("name", ["magma", "turbo"])
def test_colormap_tables_equal_matplotlibs(name):
    import matplotlib.pyplot as plt

    cmap = plt.get_cmap(name)
    ref = np.asarray([cmap(i / 255.0)[:3] for i in range(256)], np.float32)
    table = getattr(colormaps, f"{name.upper()}_TABLE")
    assert table.dtype == np.float32 and table.shape == (256, 3)
    np.testing.assert_array_equal(table, ref)
