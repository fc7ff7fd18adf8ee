"""The port's binning tile (``tile_shape``) against the JAX package's, on the CPU.

Same numpy-drawn scenes on both sides; the JAX package runs its Pallas
kernels in interpret mode, as tests/test_tile_shape.py does.

- preprocess at 32x16 and 32x32: ``rect_min``, ``rect_max`` and
  ``tiles_touched`` exactly;
- the per-binning-tile Gaussian id lists at 32x16 under Z_DEPTH,
  PTD_CENTER and PTD_MAX, and with tile-based culling, exactly;
- GLOBAL at 32x16 and 32x32 against JAX ``render_tiled(tile_x=, tile_y=)``
  at atol 5e-5 (image, final T), and against the port's own 16x16;
- the 8 API gradients at 32x16 against the JAX package's (its torch front
  end, which differentiates with ``jax.grad``) at rtol 1e-3, atol 1e-4 of
  each gradient's largest value (JAX's own tolerance);
- PPX_KBUFFER at 32x16: forward at 2e-5 and gradients as above; HIER and
  PPX_FULL at 32x16 against JAX's 32x16 render;
- an image of odd 16x16 width (80x48): the right column of 32x16 binning
  tiles has no second half on the image, and its plane stays zero;
- the plain K2, K4 and K6 at two planes, summed, against autograd through
  the plain K1, K3 and K5 on the split segments;
- unsupported bins raise NotImplementedError naming the binning tile;
- one GLOBAL train step with ``render_kwargs={"tile_shape": (32, 16)}``
  against JAX ``make_train_step`` at rtol 1e-4, and the train CLI with
  ``--tile auto`` (32x16 in GLOBAL) and ``--tile 16x16``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stopthepop_tpu import config as jconfig
from stopthepop_tpu import torch_compat as tc
from stopthepop_tpu.config import GlobalSortOrder as JOrder
from stopthepop_tpu.models.gaussians import init_random as jax_init_random
from stopthepop_tpu.render import rasterize as jax_rasterize
from stopthepop_tpu.render.duplicate import build_pairs as jax_build_pairs
from stopthepop_tpu.render.pipeline import render_tiled as jax_render_tiled
from stopthepop_tpu.render.pipeline import render_tiled_full as jax_render_full
from stopthepop_tpu.render.preprocess import preprocess as jax_preprocess
from stopthepop_tpu.train import trainer as jtrainer

import stopthepop_tpu_torch as stt
from stopthepop_tpu_torch.config import GlobalSortOrder, SortMode
from stopthepop_tpu_torch.io.cameras import CameraArrays
from stopthepop_tpu_torch.kernels import global_blend as gb
from stopthepop_tpu_torch.kernels import hier_blend as hb
from stopthepop_tpu_torch.kernels import kbuffer_blend as kb
from stopthepop_tpu_torch.kernels.blend_vjp import reduce_pair_grads, sum_planes
from stopthepop_tpu_torch.models.gaussians import from_numpy_params
from stopthepop_tpu_torch.ops.covariance import compute_cov3d
from stopthepop_tpu_torch.render.duplicate import build_pairs, count_pairs
from stopthepop_tpu_torch.render.pipeline import (
    render_tiled,
    split_binning_segments,
    tile_grid,
)
from stopthepop_tpu_torch.render.preprocess import preprocess
from stopthepop_tpu_torch.train import cli
from stopthepop_tpu_torch.train.trainer import (
    init_densify_stats,
    init_train_state,
    make_3dgs_optimizer,
    make_train_step,
)
from stopthepop_tpu_torch.utils.synthetic import (
    structured_scene,
    write_nerf_synthetic,
)
from stopthepop_tpu_torch.utils.testing import (
    make_camera,
    one_thread_under_xdist,
    random_scene,
)

one_thread_under_xdist()

BG = np.array([0.2, 0.1, 0.3], np.float32)


def j(x):
    return jnp.asarray(np.asarray(x))


def _preps(w, h, tile, order=GlobalSortOrder.Z_DEPTH, seed=11, n=250,
           **scene_kw):
    """(port prep, JAX prep, scene, camera) at binning tile ``tile``."""
    scene = random_scene(seed, n, device="cpu", **scene_kw)
    cam = make_camera(w, h, device="cpu")
    kw = dict(tanfovx=cam.tanfovx, tanfovy=cam.tanfovy, image_width=w,
              image_height=h, sh_degree=3, rect_bounding=True,
              tight_opacity_bounding=True, tile_x=tile[0], tile_y=tile[1])
    t = preprocess(scene.means3d, scene.opacities, scales=scene.scales,
                   rotations=scene.rotations, shs=scene.shs,
                   viewmatrix=cam.viewmatrix, projmatrix=cam.projmatrix,
                   campos=cam.campos, sort_order=order, **kw)
    jp = jax_preprocess(
        j(scene.means3d), j(scene.opacities), scales=j(scene.scales),
        rotations=j(scene.rotations), shs=j(scene.shs),
        viewmatrix=j(cam.viewmatrix), projmatrix=j(cam.projmatrix),
        campos=j(cam.campos), sort_order=JOrder(int(order)), **kw)
    return t, jp, scene, cam


@pytest.mark.parametrize("tile", [(32, 16), (32, 32)], ids=["32x16", "32x32"])
def test_rects_match_jax(tile):
    t, jp, _, _ = _preps(70, 45, tile)
    for name in ("rect_min", "rect_max", "tiles_touched", "valid"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(jp, name)),
                                      err_msg=name)
    # Coarser bins: fewer pairs than at 16x16.
    t16, _, _, _ = _preps(70, 45, (16, 16))
    assert 0 < int(count_pairs(t)) < int(count_pairs(t16))


@pytest.mark.parametrize("order,cull", [
    (GlobalSortOrder.Z_DEPTH, False), (GlobalSortOrder.Z_DEPTH, True),
    (GlobalSortOrder.PTD_CENTER, False), (GlobalSortOrder.PTD_MAX, True)],
    ids=["zdepth", "zdepth-tilecull", "ptd_center", "ptd_max-tilecull"])
def test_binning_tile_id_lists_match_jax(order, cull):
    w, h = 70, 45
    t, jp, _, cam = _preps(w, h, (32, 16), order, seed=13)
    gx, gy = tile_grid(w, h, 32, 16)
    cam_kw = dict(image_width=w, image_height=h, tile_x=32, tile_y=16)
    pairs = build_pairs(t, grid_x=gx, grid_y=gy, sort_order=order,
                        tile_based_culling=cull, campos=cam.campos,
                        inverse_vp=cam.inv_viewprojmatrix, **cam_kw)
    jpairs = jax_build_pairs(
        jp, capacity=int(count_pairs(t)) + 64, grid_x=gx, grid_y=gy,
        sort_order=JOrder(int(order)), tile_based_culling=cull,
        campos=j(cam.campos), inverse_vp=j(cam.inv_viewprojmatrix), **cam_kw)
    jstarts, jends = np.asarray(jpairs.starts), np.asarray(jpairs.ends)
    jgid, jvalid = np.asarray(jpairs.gauss_id), np.asarray(jpairs.valid)
    starts, ends = pairs.starts.numpy(), pairs.ends.numpy()
    gid = pairs.gauss_id.numpy()
    for tile in range(gx * gy):
        seg = slice(jstarts[tile], jends[tile])
        np.testing.assert_array_equal(gid[starts[tile]:ends[tile]],
                                      jgid[seg][jvalid[seg]],
                                      err_msg=f"binning tile {tile}")
    assert pairs.num_rendered == int(jvalid.sum()) > 0
    if cull:
        assert pairs.num_rendered < int(count_pairs(t))


@pytest.mark.parametrize("tile", [(32, 16), (32, 32)], ids=["32x16", "32x32"])
def test_global_matches_jax_render_tiled(tile):
    w, h = 64, 32
    t, jp, scene, cam = _preps(w, h, tile, n=200, seed=2)
    img, T, _, pairs, _ = render_tiled(t, torch.from_numpy(BG), image_width=w,
                                       image_height=h, tile_x=tile[0],
                                       tile_y=tile[1])
    jimg, jT, _, jpairs, _ = jax_render_tiled(
        jp, jnp.asarray(BG), image_width=w, image_height=h,
        capacity=pairs.num_rendered + 128, tile_x=tile[0], tile_y=tile[1],
        interpret=True)
    assert not bool(jpairs.overflow)
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), atol=5e-5)
    np.testing.assert_allclose(T.numpy(), np.asarray(jT), atol=5e-5)
    # The binning tile changes which pairs exist, not what Z_DEPTH blends.
    t16, _, _, _ = _preps(w, h, (16, 16), n=200, seed=2)
    img16, T16, _, pairs16, _ = render_tiled(t16, torch.from_numpy(BG),
                                             image_width=w, image_height=h)
    assert pairs.num_rendered < pairs16.num_rendered
    np.testing.assert_allclose(img.numpy(), img16.numpy(), atol=5e-5)
    np.testing.assert_allclose(T.numpy(), T16.numpy(), atol=5e-5)


def _settings(mod, cam, as_array, mode=SortMode.GLOBAL, tile_cull=False):
    """Raster settings of the port's or the JAX package's config ``mod``:
    rect and tight-opacity bounding, HIER queues (16, 8, 4), k = 4."""
    ext = mod.ExtendedSettings()
    ext.sort_settings.sort_mode = mod.SortMode(int(mode))
    ext.sort_settings.queue_sizes.per_pixel = 4
    ext.sort_settings.queue_sizes.tile_4x4 = 16
    ext.sort_settings.queue_sizes.tile_2x2 = 8
    ext.culling_settings.rect_bounding = True
    ext.culling_settings.tight_opacity_bounding = True
    ext.culling_settings.tile_based_culling = tile_cull
    return mod.GaussianRasterizationSettings(
        image_height=cam.height, image_width=cam.width, tanfovx=cam.tanfovx,
        tanfovy=cam.tanfovy, bg=as_array(BG), scale_modifier=1.0,
        viewmatrix=as_array(cam.viewmatrix),
        projmatrix=as_array(cam.projmatrix),
        inv_viewprojmatrix=as_array(cam.inv_viewprojmatrix), sh_degree=3,
        campos=as_array(cam.campos), prefiltered=False, settings=ext)


def _assert_grads_close(got, ref, names, rtol=1e-3, atol=1e-4):
    for name in names:
        g, r = np.asarray(got[name]), np.asarray(ref[name])
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, r, rtol=rtol,
                                   atol=atol * (np.abs(r).max() + 1e-12),
                                   err_msg=f"gradient of {name}")


def test_api_gradients_match_jax_at_32x16():
    w, h = 64, 32
    scene = random_scene(8, 60, device="cpu")
    cam = make_camera(w, h, device="cpu")
    weights = torch.from_numpy(
        np.random.default_rng(3).standard_normal((3, h, w)).astype(np.float32))
    inputs = dict(means3D=scene.means3d, means2D=torch.zeros((60, 3)),
                  opacities=scene.opacities[:, None], shs=scene.shs,
                  scales=scene.scales, rotations=scene.rotations)

    def run(rasterizer):
        leaves = {k: v.clone().requires_grad_(True) for k, v in inputs.items()}
        color, radii = rasterizer(**leaves)
        (color * weights).sum().backward()
        return color.detach(), radii, {k: v.grad for k, v in leaves.items()}

    port = stt.GaussianRasterizer(_settings(stt, cam, torch.as_tensor),
                                  tile_shape=(32, 16))
    ref = tc.GaussianRasterizer(_settings(tc, cam, torch.as_tensor),
                                interpret=True, tile_shape=(32, 16))
    color, radii, grads = run(port)
    rcolor, rradii, rgrads = run(ref)
    np.testing.assert_allclose(color.numpy(), rcolor.numpy(), atol=5e-5)
    np.testing.assert_array_equal(radii.numpy(), rradii.numpy())
    assert grads["means2D"].abs().max() > 0
    _assert_grads_close(grads, rgrads, ["means3D", "means2D", "opacities",
                                        "shs", "scales", "rotations"])
    # The two other reference inputs, through the colour / covariance path.
    cov = compute_cov3d(scene.scales, 1.0, scene.rotations)
    inputs = dict(means3D=scene.means3d, means2D=torch.zeros((60, 3)),
                  opacities=scene.opacities[:, None],
                  colors_precomp=scene.colors, cov3D_precomp=cov)
    _, _, grads = run(port)
    _, _, rgrads = run(ref)
    _assert_grads_close(grads, rgrads, ["colors_precomp", "cov3D_precomp"])


def _jax_api(scene, cam, mode, tile_shape):
    rs = _settings(jconfig, cam, j, mode)

    def loss(opacities, weights):
        img, _ = jax_rasterize.rasterize_gaussians(
            j(scene.means3d), None, j(scene.shs), None, opacities,
            j(scene.scales), j(scene.rotations), None, rs, interpret=True,
            pair_capacity=4096, tile_shape=tile_shape)
        return jnp.sum(img * weights), img
    return loss


def _port_api(scene, cam, mode, tile_shape, weights, grad=True):
    rs = _settings(stt, cam, torch.as_tensor, mode)
    opac = scene.opacities.clone().requires_grad_(grad)
    img, _ = stt.rasterize_gaussians(
        scene.means3d, None, scene.shs, None, opac, scene.scales,
        scene.rotations, None, rs, tile_shape=tile_shape,
        full_mode="tiled" if mode == SortMode.PPX_FULL else "auto")
    if not grad:
        return img, None
    (img * weights).sum().backward()
    return img.detach(), opac.grad


def test_kbuffer_matches_jax_at_32x16_on_an_odd_width():
    """80x48: five 16x16 columns, so the right column of 32x16 bins has no
    second half on the image."""
    w, h = 80, 48
    scene = random_scene(7, 80, device="cpu")
    cam = make_camera(w, h, device="cpu")
    weights = np.random.default_rng(1).standard_normal(
        (3, h, w)).astype(np.float32)
    img, grad = _port_api(scene, cam, SortMode.PPX_KBUFFER, (32, 16),
                          torch.from_numpy(weights))
    (_, jimg), jgrad = jax.value_and_grad(
        _jax_api(scene, cam, SortMode.PPX_KBUFFER, (32, 16)), has_aux=True)(
            j(scene.opacities), jnp.asarray(weights))
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), atol=2e-5)
    assert np.abs(grad.numpy()).max() > 0
    _assert_grads_close({"opacities": grad}, {"opacities": jgrad},
                        ["opacities"])


def test_hier_matches_jax_at_32x16():
    """The render against JAX's at 32x16; the gradients against the port's
    own 16x16 (Z_DEPTH: every pixel sees the same cascade, as JAX's slow
    test_tile_shape_resort_modes_match_16x16 checks)."""
    w, h = 64, 16
    scene = random_scene(7, 80, device="cpu")
    cam = make_camera(w, h, device="cpu")
    weights = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (3, h, w)).astype(np.float32))
    img, grad = _port_api(scene, cam, SortMode.HIER, (32, 16), weights)
    _, jimg = _jax_api(scene, cam, SortMode.HIER, (32, 16))(
        j(scene.opacities), j(weights))
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), atol=1e-5)
    img16, grad16 = _port_api(scene, cam, SortMode.HIER, None, weights)
    np.testing.assert_allclose(img.numpy(), img16.numpy(), atol=2e-5)
    assert np.abs(grad.numpy()).max() > 0
    _assert_grads_close({"opacities": grad}, {"opacities": grad16},
                        ["opacities"])


def test_full_matches_jax_at_32x16():
    w, h = 64, 16
    t, jp, _, cam = _preps(w, h, (32, 16), n=80, seed=3)
    img, _ = _port_api(random_scene(3, 80, device="cpu"), cam,
                       SortMode.PPX_FULL, (32, 16), None, grad=False)
    jimg, jT, _, jpairs, _ = jax_render_full(
        jp, jnp.asarray(BG), image_width=w, image_height=h, capacity=4096,
        campos=j(cam.campos), inverse_vp=j(cam.inv_viewprojmatrix),
        tile_x=32, tile_y=16, interpret=True)
    assert not bool(jpairs.overflow)
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), atol=5e-5)


def _cotangents(w, h, seed=1):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((3, h, w)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((h, w)).astype(np.float32)))


@pytest.mark.parametrize("kernel", ["k2", "k4", "k6"])
def test_plain_plane_sums_match_autograd(kernel):
    """At 80x48 with 32x16 bins (odd 16x16 width: the right column's second
    plane is written by no tile and stays zero), the plain backward's two
    planes, summed, against autograd through the plain forward."""
    w, h = 80, 48
    t, _, _, cam = _preps(w, h, (32, 16), n=150, seed=8,
                          scale_range=(0.05, 0.3))
    gx, gy = tile_grid(w, h, 32, 16)
    pairs = build_pairs(t, grid_x=gx, grid_y=gy)
    segs = split_binning_segments(pairs.starts, pairs.ends, w, h, 32, 16)
    assert segs.num_sub == 2 and segs.starts.shape == (15,)
    rows = [x.detach().clone().requires_grad_(True)
            for x in (t.mean2d, t.conic_opacity, t.rgb)]
    kw = dict(grid_x=5, grid_y=3, width=w, height=h)
    cam_rows = (t.cov3d_inv9.detach(), cam.inv_viewprojmatrix, cam.campos)
    if kernel == "k2":
        extra, fwd, bwd = ((t.depth.detach(),), gb.blend_global_forward_plain,
                           gb.blend_global_backward)
        bwd_extra = ()
    elif kernel == "k4":
        extra, fwd, bwd = cam_rows, kb.blend_kbuffer_forward_plain, \
            kb.blend_kbuffer_backward
        bwd_extra, kw = cam_rows, {**kw, "k": 4}
    else:
        extra = (t.cov3d_inv9.detach(), t.opacity_power_threshold.detach(),
                 cam.inv_viewprojmatrix, cam.campos)
        fwd, bwd, bwd_extra = hb.blend_hier_forward_plain, \
            hb.blend_hier_backward, extra
        kw = {**kw, "queue_sizes": (16, 8, 4), "hier_4x4_culling": False}
    g_color, g_t = _cotangents(w, h)
    color, final_t, n_contrib, _ = fwd(pairs.gauss_id, segs.starts, segs.ends,
                                       *rows, *extra, **kw)
    expect = torch.autograd.grad(
        (color * g_color).sum() + (final_t * g_t).sum(), rows)
    planes = bwd(pairs.gauss_id, segs.starts, segs.ends,
                 *(r.detach() for r in rows), *bwd_extra, color.detach(),
                 final_t.detach(), n_contrib, g_color, g_t, **kw,
                 sub_tile=segs.sub_tile, num_sub=2)
    assert planes.shape == (2, pairs.num_rendered, 9)
    # The parents of the right column (binning x = 2) have no second half.
    right = [int(pairs.starts[2 + 3 * by]) for by in range(3)]
    right_end = [int(pairs.ends[2 + 3 * by]) for by in range(3)]
    for s, e in zip(right, right_end):
        assert e > s and (planes[1, s:e] == 0).all()
    assert (planes[0] != 0).any() and (planes[1] != 0).any()
    d = reduce_pair_grads(sum_planes(planes), pairs.orig_slot,
                          pairs.gauss_offsets)
    for name, got, ref in zip(("xy", "conic_opacity", "rgb"),
                              (d[:, 0:2], d[:, 2:6], d[:, 6:9]), expect):
        scale = ref.abs().amax(dim=0)
        assert (scale > 0).all(), name
        assert ((got - ref).abs() <= 1e-5 * scale).all(), name
    # One plane through a zero map is the [N, 9] of no map, to the bit.
    one = bwd(pairs.gauss_id, segs.starts, segs.ends,
              *(r.detach() for r in rows), *bwd_extra, color.detach(),
              final_t.detach(), n_contrib, g_color, g_t, **kw,
              sub_tile=torch.zeros_like(segs.sub_tile), num_sub=1)
    none = bwd(pairs.gauss_id, segs.starts, segs.ends,
               *(r.detach() for r in rows), *bwd_extra, color.detach(),
               final_t.detach(), n_contrib, g_color, g_t, **kw)
    assert one.shape == (1, *none.shape) and torch.equal(one[0], none)


def test_debug_fields_and_dense_full_at_32x16():
    """The debug fields and the dense PPX_FULL oracle read the binning tile
    ``prep`` was made for: at 32x16 the sort-error maps and the dense FULL
    image are the 16x16 ones, and each 16x16 tile's pair count is its
    binning tile's."""
    w, h = 80, 48
    scene = random_scene(5, 120, device="cpu")
    cam = make_camera(w, h, device="cpu")
    rs = _settings(stt, cam, torch.as_tensor)
    args = (scene.means3d, None, scene.shs, None, scene.opacities,
            scene.scales, scene.rotations, None)
    for mode in (stt.DebugVisualization.SortErrorOpacity,
                 stt.DebugVisualization.SortErrorDistance):
        got = stt.rasterize_gaussians(*args, rs, debug_visualization=mode,
                                      tile_shape=(32, 16))[0]
        ref = stt.rasterize_gaussians(*args, rs, debug_visualization=mode)[0]
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    data = stt.render.debug_viz.DebugVisualizationData(debug_pixel=(70, 40))
    stt.rasterize_gaussians(
        *args, rs, debug_visualization=stt.DebugVisualization.GaussianCountPerTile,
        debug_data=data, tile_shape=(32, 16))
    t, _, _, _ = _preps(w, h, (32, 16), seed=5, n=120)
    pairs = build_pairs(t, grid_x=3, grid_y=3)
    # Pixel (70, 40) lies in 16x16 tile (4, 2), binning tile (2, 2).
    assert data.debug_pixel_value == float(pairs.ends[8] - pairs.starts[8])
    full = _settings(stt, cam, torch.as_tensor, SortMode.PPX_FULL)
    got = stt.rasterize_gaussians(*args, full, full_mode="naive",
                                  tile_shape=(32, 16))[0]
    ref = stt.rasterize_gaussians(*args, full, full_mode="naive")[0]
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode,tile", [
    (SortMode.PPX_KBUFFER, (32, 32)), (SortMode.HIER, (16, 32)),
    (SortMode.PPX_FULL, (48, 16)), (SortMode.GLOBAL, (24, 16))],
    ids=["kbuffer-32x32", "hier-16x32", "full-48x16", "global-24x16"])
def test_unsupported_binning_tiles_raise(mode, tile):
    scene = random_scene(0, 8, device="cpu")
    cam = make_camera(32, 32, device="cpu")
    r = stt.GaussianRasterizer(_settings(stt, cam, torch.as_tensor, mode),
                               tile_shape=tile)
    args = (scene.means3d, None, scene.opacities)
    kw = dict(shs=scene.shs, scales=scene.scales, rotations=scene.rotations)
    if mode == SortMode.GLOBAL:
        # GLOBAL takes any binning tile, as the JAX package's kernels do:
        # 24x16 renders the 16x16 image (tight-opacity bounding).
        ref = stt.GaussianRasterizer(
            _settings(stt, cam, torch.as_tensor, mode))(*args, **kw)[0]
        torch.testing.assert_close(r(*args, **kw)[0], ref, rtol=0, atol=0)
        return
    with pytest.raises(NotImplementedError, match="binning tile"):
        r(*args, **kw)


def test_global_train_step_matches_jax_at_32x16():
    size = 48
    cam = make_camera(size, size, device="cpu")
    static = _settings(stt, cam, torch.as_tensor, tile_cull=True)
    jstatic = _settings(jconfig, cam, j, tile_cull=True)
    jmodel = jax_init_random(jax.random.PRNGKey(1), 60, extent=1.0)
    params = {k: np.asarray(v) for k, v in jmodel._asdict().items()}
    target = np.random.default_rng(2).uniform(
        0, 1, (3, size, size)).astype(np.float32)
    kwargs = {"tile_shape": (32, 16)}
    jopt = jtrainer.make_3dgs_optimizer(1.3, position_lr_max_steps=100)
    jstep = jax.jit(jtrainer.make_train_step(
        jopt, static=jstatic, pair_capacity=4096, interpret=True,
        render_kwargs=kwargs))
    jstate = jtrainer.init_train_state(jmodel, jopt)
    jstats = jtrainer.init_densify_stats(60)
    jcam = jtrainer.CameraArrays(j(cam.viewmatrix), j(cam.projmatrix),
                                 j(cam.inv_viewprojmatrix), j(cam.campos))
    model = from_numpy_params(params, device="cpu")
    state = init_train_state(model, make_3dgs_optimizer(
        model, 1.3, position_lr_max_steps=100))
    stats = init_densify_stats(60)
    step = make_train_step(static=static, render_kwargs=kwargs)
    tcam = CameraArrays(cam.viewmatrix, cam.projmatrix, cam.inv_viewprojmatrix,
                        cam.campos)
    for i in range(2):
        jstate, jstats, jaux = jstep(jstate, jcam, jnp.asarray(target), jstats)
        state, stats, aux = step(state, tcam, torch.from_numpy(target), stats)
        np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]),
                                   rtol=1e-4, err_msg=f"step {i}")
    np.testing.assert_allclose(state.model.means3d.detach().numpy(),
                               np.asarray(jstate.model.means3d), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_array_equal(stats.denom.numpy(), np.asarray(jstats.denom))


@pytest.mark.parametrize("tile,expect", [("auto", (32, 16)),
                                         ("16x16", None)])
def test_train_cli_binning_tile(tmp_path, monkeypatch, capsys, tile, expect):
    gt, _ = structured_scene(200, 0, device="cpu")
    write_nerf_synthetic(str(tmp_path), gt, views=2, size=32, device="cpu")
    seen = []
    real = cli.make_train_step

    def spy(**kw):
        seen.append(kw["render_kwargs"]["tile_shape"])
        return real(**kw)

    monkeypatch.setattr(cli, "make_train_step", spy)
    res = cli.main(["--data", str(tmp_path), "--iters", "2",
                    "--init-points", "80", "--eval-every", "2",
                    "--densify-from", "100", "--sort-mode", "GLOBAL",
                    "--tile", tile, "--device", "cpu"])
    assert seen == [expect]
    assert res.state.step == 2 and np.isfinite(res.eval_psnr[2])
    printed = "perf defaults: {'tile_shape': (32, 16)}" in capsys.readouterr().out
    assert printed == (expect is not None)
    assert cli.binning_tile("auto", SortMode.HIER) is None
