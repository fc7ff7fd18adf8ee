"""The port's PER_PIXEL_KBUFFER forward and its per-ray depth functions against
the JAX package's, on the CPU.

Same numpy-drawn scene on both sides. The JAX package runs its k-buffer Pallas
kernel in interpret mode, the port its plain version of kernel K3. Tolerances
of tests/test_kbuffer.py: image and final_T atol 3e-5 (5e-5 with DISTANCE
and tile culling), n_contrib (the commit count) different on under 2% of the
pixels, where a near-tie may flip the window order. The view ray, the ray
depth and the per-tile depth agree within 1e-5 (the norm is summed in
another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stopthepop_tpu.config import GlobalSortOrder as JOrder
from stopthepop_tpu.ops import stopthepop as jstp
from stopthepop_tpu.ops import transforms as jtf
from stopthepop_tpu.render.naive import render_kbuffer_naive
from stopthepop_tpu.render.pipeline import render_tiled_kbuffer as jax_render_kbuffer
from stopthepop_tpu.render.preprocess import preprocess as jax_preprocess
from stopthepop_tpu.utils.testing import bucket_pair_capacity

import stopthepop_tpu_torch as stt
from stopthepop_tpu_torch.ops.stopthepop import depth_along_ray, per_tile_depth
from stopthepop_tpu_torch.ops.transforms import compute_view_ray, pix2world
from stopthepop_tpu_torch.render.pipeline import render_tiled_kbuffer
from stopthepop_tpu_torch.render.preprocess import preprocess
from stopthepop_tpu_torch.utils.testing import (
    make_camera,
    one_thread_under_xdist,
    random_scene,
)

one_thread_under_xdist()

BG = np.array([0.15, 0.05, 0.3], np.float32)


def _j(x):
    return jnp.asarray(x.numpy())


def _preps(w, h, n, seed, order=0, cull=False, scale_range=(0.05, 0.4)):
    scene = random_scene(seed, n, scale_range=scale_range, device="cpu")
    cam = make_camera(w, h, device="cpu")
    kw = dict(tanfovx=cam.tanfovx, tanfovy=cam.tanfovy, image_width=w,
              image_height=h, sh_degree=3, rect_bounding=cull,
              tight_opacity_bounding=cull)
    t = preprocess(scene.means3d, scene.opacities, scales=scene.scales,
                   rotations=scene.rotations, shs=scene.shs,
                   viewmatrix=cam.viewmatrix, projmatrix=cam.projmatrix,
                   campos=cam.campos, sort_order=stt.GlobalSortOrder(order),
                   **kw)
    j = jax_preprocess(
        _j(scene.means3d), _j(scene.opacities), scales=_j(scene.scales),
        rotations=_j(scene.rotations), shs=_j(scene.shs),
        viewmatrix=_j(cam.viewmatrix), projmatrix=_j(cam.projmatrix),
        campos=_j(cam.campos), sort_order=JOrder(order), **kw)
    return cam, t, j


def test_view_ray_and_depths_match_jax():
    w, h = 70, 45
    cam, t, j = _preps(w, h, 50, 3)
    rng = np.random.default_rng(0)
    pix = rng.uniform(-5, 75, (64, 2)).astype(np.float32)
    inv, campos = cam.inv_viewprojmatrix, cam.campos
    np.testing.assert_allclose(
        pix2world(torch.from_numpy(pix), w, h, inv).numpy(),
        np.asarray(jtf.pix2world(jnp.asarray(pix), w, h, _j(inv))), atol=1e-5)
    ray = compute_view_ray(torch.from_numpy(pix), w, h, inv, campos)
    jray = jtf.compute_view_ray(jnp.asarray(pix), w, h, _j(inv), _j(campos))
    np.testing.assert_allclose(ray.numpy(), np.asarray(jray), atol=1e-5)
    depth = depth_along_ray(t.cov3d_inv9[:, None, :], ray[None])
    jdepth = jstp.depth_along_ray(j.cov3d_inv9[:, None, :], jray[None])
    np.testing.assert_allclose(depth.numpy(), np.asarray(jdepth), rtol=1e-5,
                               atol=1e-5)
    # Half the rows with u = Sigma^-1 (mean - campos) scaled by -10: their
    # depths fall far behind the camera, below the -8 of the floor.
    inv9 = t.cov3d_inv9.clone()
    inv9[::2, 6:] *= -10.0
    ptd = per_tile_depth(torch.from_numpy(pix)[None], inv9[:, None, :],
                         campos, w, h, inv)
    jptd = jstp.per_tile_depth(jnp.asarray(pix)[None], _j(inv9)[:, None, :],
                               _j(campos), w, h, _j(inv))
    assert (ptd >= 0).all() and (ptd == 0).any()  # the floor is exercised
    np.testing.assert_allclose(ptd.numpy(), np.asarray(jptd), rtol=1e-5,
                               atol=1e-5)


def _render_port(cam, t, w, h, k, order=0, cull=False):
    return render_tiled_kbuffer(
        t, torch.from_numpy(BG), image_width=w, image_height=h,
        campos=cam.campos, inverse_vp=cam.inv_viewprojmatrix, k=k,
        sort_order=stt.GlobalSortOrder(order), tile_based_culling=cull)


@pytest.mark.parametrize("k", [1, 4, 8])
def test_kbuffer_render_matches_jax_kernel(k):
    # A scene without near-ties of ray depths: the Pallas kernel forms the
    # view ray with a reciprocal where its oracle (render/naive.py) and the
    # port divide, and a near-tie can swap two window entries (denser scenes
    # are held against the oracle below).
    w = h = 48
    cam, t, j = _preps(w, h, 200, 6, scale_range=(0.02, 0.2))
    img, final_t, n_contrib, pairs, _ = _render_port(cam, t, w, h, k)
    jimg, jt, jn, _, _ = jax_render_kbuffer(
        j, jnp.asarray(BG), image_width=w, image_height=h,
        capacity=bucket_pair_capacity(j), campos=_j(cam.campos),
        inverse_vp=_j(cam.inv_viewprojmatrix), k=k, interpret=True)
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), atol=3e-5)
    np.testing.assert_allclose(final_t.numpy(), np.asarray(jt), atol=3e-5)
    assert n_contrib.dtype == torch.int32
    assert (n_contrib.numpy() != np.asarray(jn)).mean() < 0.02
    assert (final_t < 1e-2).any() and n_contrib.max() > k  # windows overflow


def test_kbuffer_distance_tile_culling_matches_jax_kernel():
    w = h = 32
    cam, t, j = _preps(w, h, 100, 7, order=1, cull=True)
    img, final_t, _, _, _ = _render_port(cam, t, w, h, 4, order=1, cull=True)
    jimg, jt, _, _, _ = jax_render_kbuffer(
        j, jnp.asarray(BG), image_width=w, image_height=h,
        capacity=bucket_pair_capacity(j), campos=_j(cam.campos),
        inverse_vp=_j(cam.inv_viewprojmatrix), k=4,
        sort_order=JOrder.DISTANCE, tile_based_culling=True, interpret=True)
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), atol=5e-5)
    np.testing.assert_allclose(final_t.numpy(), np.asarray(jt), atol=5e-5)


@pytest.mark.parametrize("order,cull,k", [(2, False, 4), (3, True, 2), (0, True, 24)],
                         ids=["ptd_center", "ptd_max-tilecull", "zdepth-tilecull-k24"])
def test_kbuffer_orders_match_jax_oracle(order, cull, k):
    # The JAX package's k-buffer oracle (render/naive.py) under the
    # per-tile-depth stream orders and the largest window.
    w, h = 40, 32
    cam, t, j = _preps(w, h, 120, 9, order=order, cull=cull)
    img, final_t, n_contrib, _, _ = _render_port(cam, t, w, h, k, order, cull)
    jimg, jt, jn = render_kbuffer_naive(
        j, jnp.asarray(BG), w, h, _j(cam.campos), _j(cam.inv_viewprojmatrix),
        k=k, sort_order=JOrder(order), tile_based_culling=cull)
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), atol=3e-5)
    np.testing.assert_allclose(final_t.numpy().reshape(-1), np.asarray(jt),
                               atol=3e-5)
    assert (n_contrib.numpy().reshape(-1) != np.asarray(jn)).mean() < 0.02


def _rasterizer_settings(k):
    cam = make_camera(32, 32, device="cpu")
    ext = stt.ExtendedSettings()
    ext.sort_settings.sort_mode = stt.SortMode.PPX_KBUFFER
    ext.sort_settings.queue_sizes.per_pixel = k
    return stt.GaussianRasterizationSettings(
        image_height=32, image_width=32, tanfovx=cam.tanfovx,
        tanfovy=cam.tanfovy, bg=torch.from_numpy(BG), scale_modifier=1.0,
        viewmatrix=cam.viewmatrix, projmatrix=cam.projmatrix,
        inv_viewprojmatrix=cam.inv_viewprojmatrix, sh_degree=3,
        campos=cam.campos, prefiltered=False, settings=ext)


@pytest.mark.parametrize("k", [0, 25])
def test_window_size_out_of_range_raises(k):
    scene = random_scene(0, 20, device="cpu")
    with pytest.raises(ValueError, match="1..24"):
        stt.GaussianRasterizer(_rasterizer_settings(k))(
            scene.means3d, None, scene.opacities, colors_precomp=scene.colors,
            scales=scene.scales, rotations=scene.rotations)


@pytest.mark.parametrize("mode,order", [(2, 0), (0, 2)],
                         ids=["kbuffer", "global-ptd_center"])
def test_per_ray_depths_need_the_inverse_view_projection(mode, order):
    scene = random_scene(0, 20, device="cpu")
    rs = _rasterizer_settings(4)
    rs.settings.sort_settings.sort_mode = stt.SortMode(mode)
    rs.settings.sort_settings.sort_order = stt.GlobalSortOrder(order)
    with pytest.raises(ValueError, match="inv_viewprojmatrix"):
        stt.GaussianRasterizer(rs._replace(inv_viewprojmatrix=None))(
            scene.means3d, None, scene.opacities, colors_precomp=scene.colors,
            scales=scene.scales, rotations=scene.rotations)


def test_full_output_reports_commit_counts_and_ray_depths():
    scene = random_scene(4, 60, scale_range=(0.05, 0.4), device="cpu")
    with torch.no_grad():
        out = stt.GaussianRasterizer(_rasterizer_settings(4), full_output=True)(
            scene.means3d, None, scene.opacities, colors_precomp=scene.colors,
            scales=scene.scales, rotations=scene.rotations)
    covered = out.n_contrib > 0
    assert out.num_rendered > 0 and covered.any()
    # The depth accumulator holds sum(w * ray depth): positive where covered,
    # exactly 0 elsewhere; 1 - final_T is the sum of the weights.
    assert (out.depth_acc[covered] > 0).all() and (out.depth_acc[~covered] == 0).all()
    assert (out.final_t[~covered] == 1).all()
    assert torch.isfinite(out.color).all()
