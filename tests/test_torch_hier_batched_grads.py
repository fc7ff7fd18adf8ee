"""The port's HIERARCHICAL batched cascade backward (plain version of kernel
K6 with ``batched_cascade=True``, ``BlendHier`` and the API) against
autograd and the JAX package's gradients, on the CPU.

- The plain batched K6 against ``torch.autograd`` through the plain batched
  K5 (written in differentiable torch operations): per-Gaussian gradients
  within 1e-5 of each column's largest value, on a one-tile stream that
  crosses several 64-entry tail batches, at mid windows that are no
  multiple of the sub-batch of 8 ((16, 5, 3) and (32, 20, 16)), and with
  hierarchical 4x4 and tile-based culling.
- The 8 gradients of ``GaussianRasterizer(..., batched_cascade=True)`` in
  HIER against ``jax.grad`` of the JAX package's preprocess and its batched
  oracle (``render/naive.py::render_hierarchical_naive(batched_cascade=
  True)``, eager under ``jax.disable_jit()``), at 16x16 and the gradient
  tolerances of tests/test_hierarchical.py (atol 3e-4 of the largest value,
  rtol 3e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stopthepop_tpu.render.naive import render_hierarchical_naive
from stopthepop_tpu.render.preprocess import preprocess as jax_preprocess

import stopthepop_tpu_torch as stt
from stopthepop_tpu_torch.kernels.blend_vjp import reduce_pair_grads
from stopthepop_tpu_torch.kernels.hier_blend import (
    blend_hier_backward,
    blend_hier_forward_plain,
)
from stopthepop_tpu_torch.render.duplicate import build_pairs
from stopthepop_tpu_torch.render.pipeline import tile_grid
from stopthepop_tpu_torch.render.preprocess import preprocess
from stopthepop_tpu_torch.utils.testing import (
    make_camera,
    one_thread_under_xdist,
    random_scene,
)

from test_torch_hier import BG, _hier_settings
from test_torch_hier_bwd import _assert_columns_close, _cotangents

one_thread_under_xdist()

CASES = {
    # name: (w, h, Gaussians, seed, scene kwargs, queues, culling)
    # One tile whose stream crosses several 64-entry tail batches.
    "64-8-4-deep-tile": (16, 16, 250, 22, dict(extent=0.5), (64, 8, 4),
                         False),
    "16-5-3": (48, 48, 150, 8, dict(scale_range=(0.05, 0.4)), (16, 5, 3),
               False),
    "32-20-16": (48, 48, 150, 8, dict(scale_range=(0.05, 0.4)), (32, 20, 16),
                 False),
    "16-8-4-culling": (48, 48, 150, 9, dict(scale_range=(0.05, 0.4)),
                       (16, 8, 4), True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_batched_backward_matches_autograd(case):
    w, h, n, seed, scene_kw, queues, cull = CASES[case]
    cam = make_camera(w, h, device="cpu")
    scene = random_scene(seed, n, device="cpu", **scene_kw)
    prep = preprocess(
        scene.means3d, scene.opacities, scales=scene.scales,
        rotations=scene.rotations, shs=scene.shs, viewmatrix=cam.viewmatrix,
        projmatrix=cam.projmatrix, campos=cam.campos, tanfovx=cam.tanfovx,
        tanfovy=cam.tanfovy, image_width=w, image_height=h, sh_degree=3)
    gx, gy = tile_grid(w, h)
    pairs = build_pairs(prep, grid_x=gx, grid_y=gy, tile_based_culling=cull,
                        campos=cam.campos, inverse_vp=cam.inv_viewprojmatrix,
                        image_width=w, image_height=h)
    g_color, g_t = _cotangents(w, h)
    rows = [x.detach().clone().requires_grad_(True)
            for x in (prep.mean2d, prep.conic_opacity, prep.rgb)]
    extra = (prep.cov3d_inv9.detach(), prep.opacity_power_threshold.detach(),
             cam.inv_viewprojmatrix, cam.campos)
    kw = dict(queue_sizes=queues, hier_4x4_culling=cull, grid_x=gx, grid_y=gy,
              width=w, height=h, batched_cascade=True)
    color, final_t, n_contrib, _ = blend_hier_forward_plain(
        pairs.gauss_id, pairs.starts, pairs.ends, *rows, *extra, **kw)
    expect = torch.autograd.grad(
        (color * g_color).sum() + (final_t * g_t).sum(), rows)
    d_pair = blend_hier_backward(
        pairs.gauss_id, pairs.starts, pairs.ends, *(r.detach() for r in rows),
        *extra, color.detach(), final_t.detach(), n_contrib, g_color, g_t, **kw)
    d = reduce_pair_grads(d_pair, pairs.orig_slot, pairs.gauss_offsets)
    _assert_columns_close((d[:, 0:2], d[:, 2:6], d[:, 6:9]), expect)
    assert n_contrib.max() > queues[2]  # the head window overflows
    if case == "64-8-4-deep-tile":
        assert int(pairs.ends[0] - pairs.starts[0]) > 2 * 64


def test_api_batched_gradients_match_jax_oracle():
    size, queues = 16, (16, 8, 4)
    scene = random_scene(1, 60, extent=1.0, device="cpu")
    cam = make_camera(size, size, device="cpu")
    n = scene.means3d.shape[0]
    weights = np.random.default_rng(3).standard_normal(
        (3, size, size)).astype(np.float32)
    inputs = dict(means3D=scene.means3d, means2D=torch.zeros((n, 3)),
                  opacities=scene.opacities[:, None], shs=scene.shs,
                  scales=scene.scales, rotations=scene.rotations)
    leaves = {key: v.clone().requires_grad_(True) for key, v in inputs.items()}
    color, _ = stt.GaussianRasterizer(_hier_settings(cam, queues),
                                      batched_cascade=True)(**leaves)
    loss = (color * torch.from_numpy(weights)).sum()
    loss.backward()

    j = lambda x: jnp.asarray(x.numpy())  # noqa: E731

    def jloss(means3d, means2d, opac, shs, scales, rotations):
        prep = jax_preprocess(
            means3d, opac.reshape(-1), shs=shs, scales=scales,
            rotations=rotations, viewmatrix=j(cam.viewmatrix),
            projmatrix=j(cam.projmatrix), campos=j(cam.campos),
            tanfovx=cam.tanfovx, tanfovy=cam.tanfovy, image_width=size,
            image_height=size, sh_degree=3)
        # The rasterizer's value-neutral means2D reroute.
        m2d = means2d[:, :2] * jnp.array([0.5 * size, 0.5 * size], jnp.float32)
        prep = prep._replace(mean2d=prep.mean2d + m2d - jax.lax.stop_gradient(m2d))
        img, _, _ = render_hierarchical_naive(
            prep, jnp.asarray(BG), size, size, j(cam.campos),
            j(cam.inv_viewprojmatrix), queue_sizes=queues,
            batched_cascade=True)
        return jnp.sum(img * weights)

    names = list(inputs)
    with jax.disable_jit():
        jv, jg = jax.value_and_grad(jloss, argnums=tuple(range(len(names))))(
            *(j(inputs[key]) for key in names))
    np.testing.assert_allclose(float(loss.detach()), float(jv), rtol=1e-5)
    assert leaves["means2D"].grad.abs().max() > 0
    for name, ref in zip(names, jg):
        got, ref = leaves[name].grad.numpy(), np.asarray(ref)
        assert np.isfinite(got).all(), name
        scale = np.abs(ref).max() + 1e-8
        np.testing.assert_allclose(
            got, ref, atol=3e-4 * scale, rtol=3e-3,
            err_msg=f"batched hier gradient mismatch for {name}")
