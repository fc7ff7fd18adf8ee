"""The port's gradients through preprocess + render and through the public API,
against the JAX package's, on the CPU.

Same numpy-drawn inputs on both sides; the JAX package runs its Pallas
kernels in interpret mode. Tolerance of tests/test_backward.py: atol 2e-4 of
the largest value, rtol 2e-3; losses at rtol 1e-5.

- preprocess + ``render_tiled``: gradients of means3d, scales, rotations,
  opacities and SH (or precomputed colours), over SH / precomputed colours,
  Z_DEPTH / DISTANCE, tile-based culling and proper EWA scaling (the SH
  clamp is active on some Gaussians of this scene);
- ``GaussianRasterizer``: the 8 reference gradients (means3D, means2D, sh,
  colors_precomp, opacities, scales, rotations, cov3Ds_precomp) against
  ``stopthepop_tpu.torch_compat.GaussianRasterizer``, call for call.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stopthepop_tpu import torch_compat as tc
from stopthepop_tpu.config import GlobalSortOrder as JOrder
from stopthepop_tpu.render.pipeline import render_tiled as jax_render_tiled
from stopthepop_tpu.render.preprocess import preprocess as jax_preprocess
from stopthepop_tpu.utils.testing import bucket_pair_capacity

import stopthepop_tpu_torch as stt
from stopthepop_tpu_torch.ops.covariance import compute_cov3d
from stopthepop_tpu_torch.render.pipeline import render_tiled
from stopthepop_tpu_torch.render.preprocess import preprocess
from stopthepop_tpu_torch.utils.testing import (
    make_camera,
    one_thread_under_xdist,
    random_scene,
)

one_thread_under_xdist()

BG = np.array([0.3, 0.1, 0.2], np.float32)
NAMES = ("means3d", "scales", "rotations", "opacities", "colors")


def _assert_grads_close(got, ref, names):
    for name, b, a in zip(names, got, ref):
        a, b = np.asarray(a), np.asarray(b)
        assert np.isfinite(b).all(), name
        scale = np.abs(a).max() + 1e-8
        np.testing.assert_allclose(b, a, atol=2e-4 * scale, rtol=2e-3,
                                   err_msg=f"gradient mismatch for {name}")


CASES = [
    # (use_sh, order, tile_based_culling, proper_ewa_scaling)
    (True, 0, False, False),
    (False, 0, True, False),
    (True, 1, True, False),
    (False, 1, False, True),
    (True, 0, True, True),
]


@pytest.mark.parametrize(
    "use_sh,order,tile_cull,ewa", CASES,
    ids=["sh-zdepth", "colors-zdepth-tilecull", "sh-distance-tilecull",
         "colors-distance-ewa", "sh-zdepth-tilecull-ewa"],
)
def test_preprocess_render_grads_match_jax(use_sh, order, tile_cull, ewa):
    w = h = 48
    scene = random_scene(5, 80, device="cpu")
    cam = make_camera(w, h, device="cpu")
    weights = np.random.default_rng(99).standard_normal((3, h, w)).astype(np.float32)
    col = scene.shs if use_sh else scene.colors
    args = [scene.means3d, scene.scales, scene.rotations, scene.opacities, col]
    common = dict(tanfovx=cam.tanfovx, tanfovy=cam.tanfovy, image_width=w,
                  image_height=h, sh_degree=3 if use_sh else 0,
                  rect_bounding=True, tight_opacity_bounding=True,
                  proper_ewa_scaling=ewa)
    j = lambda x: jnp.asarray(x.numpy())  # noqa: E731

    def jprep(means, scales, rots, opac, c):
        kw = dict(shs=c) if use_sh else dict(colors_precomp=c)
        return jax_preprocess(
            means, opac, scales=scales, rotations=rots,
            viewmatrix=j(cam.viewmatrix), projmatrix=j(cam.projmatrix),
            campos=j(cam.campos), sort_order=JOrder(order), **common, **kw)

    cap = bucket_pair_capacity(jprep(*(j(a) for a in args)))

    def jloss(*a):
        img, final_t, _, _, _ = jax_render_tiled(
            jprep(*a), jnp.asarray(BG), image_width=w, image_height=h,
            capacity=cap, sort_order=JOrder(order),
            tile_based_culling=tile_cull, interpret=True)
        return jnp.sum(img * weights) + 0.1 * jnp.sum(final_t)

    jv, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4))(
        *(j(a) for a in args))

    leaves = [a.clone().requires_grad_(True) for a in args]
    means, scales, rots, opac, c = leaves
    kw = dict(shs=c) if use_sh else dict(colors_precomp=c)
    prep = preprocess(means, opac, scales=scales, rotations=rots,
                      viewmatrix=cam.viewmatrix, projmatrix=cam.projmatrix,
                      campos=cam.campos, sort_order=stt.GlobalSortOrder(order),
                      **common, **kw)
    if use_sh:
        assert prep.clamped.any()  # the SH clamp's zero gradient is covered
    img, final_t, _, _, _ = render_tiled(
        prep, torch.from_numpy(BG), image_width=w, image_height=h,
        sort_order=stt.GlobalSortOrder(order), tile_based_culling=tile_cull)
    loss = (img * torch.from_numpy(weights)).sum() + 0.1 * final_t.sum()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jv), rtol=1e-5)
    _assert_grads_close([x.grad.numpy() for x in leaves], jg, NAMES)


def _api_settings(mod, cam, w, h, as_array, tile_cull):
    ext = mod.ExtendedSettings()
    ext.culling_settings.rect_bounding = True
    ext.culling_settings.tight_opacity_bounding = True
    ext.culling_settings.tile_based_culling = tile_cull
    return mod.GaussianRasterizationSettings(
        image_height=h, image_width=w, tanfovx=cam.tanfovx,
        tanfovy=cam.tanfovy, bg=as_array(BG), scale_modifier=1.0,
        viewmatrix=as_array(cam.viewmatrix), projmatrix=as_array(cam.projmatrix),
        inv_viewprojmatrix=as_array(cam.inv_viewprojmatrix), sh_degree=3,
        campos=as_array(cam.campos), prefiltered=False, settings=ext,
    )


@pytest.mark.parametrize("path", ["sh-scale-rot", "colors-cov3d"])
def test_api_gradients_match_torch_compat(path):
    w, h = 40, 32
    scene = random_scene(8, 60, device="cpu")
    cam = make_camera(w, h, device="cpu")
    weights = torch.from_numpy(
        np.random.default_rng(3).standard_normal((3, h, w)).astype(np.float32))
    means2d = torch.zeros((60, 3))
    if path == "sh-scale-rot":
        inputs = dict(means3D=scene.means3d, means2D=means2d,
                      opacities=scene.opacities[:, None], shs=scene.shs,
                      scales=scene.scales, rotations=scene.rotations)
    else:
        cov = compute_cov3d(scene.scales, 1.0, scene.rotations)
        inputs = dict(means3D=scene.means3d, means2D=means2d,
                      opacities=scene.opacities[:, None],
                      colors_precomp=scene.colors, cov3D_precomp=cov)

    def run(rasterizer):
        leaves = {k: v.clone().requires_grad_(True) for k, v in inputs.items()}
        color, radii = rasterizer(**leaves)
        (color * weights).sum().backward()
        return color.detach(), radii, {k: v.grad for k, v in leaves.items()}

    tile_cull = path == "sh-scale-rot"
    port = stt.GaussianRasterizer(
        _api_settings(stt, cam, w, h, torch.as_tensor, tile_cull))
    ref = tc.GaussianRasterizer(
        _api_settings(tc, cam, w, h, torch.as_tensor, tile_cull), interpret=True)
    color, radii, grads = run(port)
    rcolor, rradii, rgrads = run(ref)
    np.testing.assert_allclose(color.numpy(), rcolor.numpy(), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(radii.numpy(), rradii.numpy())
    assert grads.keys() == rgrads.keys() == inputs.keys()
    assert grads["means2D"].abs().max() > 0
    _assert_grads_close([grads[k].numpy() for k in grads],
                        [rgrads[k].numpy() for k in grads], list(grads))


def test_means2d_dummy_is_value_neutral_and_scaled():
    w, h = 40, 32
    scene = random_scene(9, 50, device="cpu")
    cam = make_camera(w, h, device="cpu")
    rs = _api_settings(stt, cam, w, h, torch.as_tensor, False)
    means = scene.means3d.clone().requires_grad_(True)
    m2d = torch.zeros((50, 3), requires_grad=True)
    color, _ = stt.GaussianRasterizer(rs)(
        means, m2d, scene.opacities, colors_precomp=scene.colors,
        scales=scene.scales, rotations=scene.rotations)
    with torch.no_grad():
        plain, _ = stt.GaussianRasterizer(rs)(
            scene.means3d, None, scene.opacities, colors_precomp=scene.colors,
            scales=scene.scales, rotations=scene.rotations)
    torch.testing.assert_close(color.detach(), plain, rtol=0, atol=0)
    color.square().sum().backward()
    assert (m2d.grad[:, 2] == 0).all() and m2d.grad[:, :2].abs().max() > 0
    assert torch.isfinite(means.grad).all()

