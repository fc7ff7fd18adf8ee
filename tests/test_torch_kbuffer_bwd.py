"""The port's PER_PIXEL_KBUFFER backward against autograd and the JAX package's
gradients, on the CPU.

- The plain version of kernel K4 against ``torch.autograd`` through the plain
  version of K3 (written in differentiable torch operations): per-Gaussian
  gradients within 1e-5 of each column's largest value, over window sizes,
  DISTANCE and tile culling. The two share no gradient code.
- The plain K4 on a step where lanes of one warp commit the same pair: its
  grouped routing (``_route_grouped``) sums them before their row, the
  result meets autograd at the same 1e-5, and lane-by-lane routing gives
  other bits there.
- The 8 gradients of ``GaussianRasterizer`` in PPX_KBUFFER mode (means3D,
  means2D, sh, colors_precomp, opacities, scales, rotations, cov3Ds_precomp)
  against ``jax.grad`` of the JAX package's preprocess and its k-buffer
  oracle ``render/naive.py::render_kbuffer_naive`` with the means2D dummy
  written out as its rasterizer writes it. Tolerances of
  tests/test_backward.py's k-buffer test: loss rtol 1e-5, gradients atol
  3e-4 of the largest value and rtol 3e-3.
- One training step in PPX_KBUFFER against the JAX ``make_train_step`` (its
  Pallas kernels in interpret mode): loss at rtol 1e-4.
- The training CLI with ``--sort-mode PPX_KBUFFER`` at a tiny size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stopthepop_tpu
from stopthepop_tpu.config import SortMode as JMode
from stopthepop_tpu.models.gaussians import init_random as jax_init_random
from stopthepop_tpu.render.naive import render_kbuffer_naive
from stopthepop_tpu.render.preprocess import preprocess as jax_preprocess
from stopthepop_tpu.train import trainer as jtrainer

import stopthepop_tpu_torch as stt
from stopthepop_tpu_torch.io.cameras import CameraArrays
from stopthepop_tpu_torch.kernels import kbuffer_blend
from stopthepop_tpu_torch.kernels.blend_vjp import reduce_pair_grads
from stopthepop_tpu_torch.kernels.kbuffer_blend import (
    blend_kbuffer_backward,
    blend_kbuffer_forward_plain,
)
from stopthepop_tpu_torch.models.gaussians import from_numpy_params
from stopthepop_tpu_torch.ops.covariance import compute_cov3d
from stopthepop_tpu_torch.render.duplicate import build_pairs
from stopthepop_tpu_torch.render.pipeline import tile_grid
from stopthepop_tpu_torch.render.preprocess import preprocess
from stopthepop_tpu_torch.train import cli
from stopthepop_tpu_torch.train.trainer import (
    init_densify_stats,
    init_train_state,
    make_3dgs_optimizer,
    make_train_step,
)
from stopthepop_tpu_torch.utils.synthetic import structured_scene, write_nerf_synthetic
from stopthepop_tpu_torch.utils.testing import (
    make_camera,
    one_thread_under_xdist,
    random_scene,
)

one_thread_under_xdist()

BG = np.array([0.3, 0.1, 0.2], np.float32)


def _autograd_case(k, order, cull):
    """A 70x45 scene's K3 inputs with seeded cotangents: (pairs, rows
    [xy, conic_opacity, rgb] that require grad, the camera arguments, the
    keywords, the cotangents (g_color, g_t))."""
    w, h = 70, 45
    scene = random_scene(5, 200, scale_range=(0.05, 0.4), device="cpu")
    cam = make_camera(w, h, device="cpu")
    prep = preprocess(
        scene.means3d, scene.opacities, scales=scene.scales,
        rotations=scene.rotations, shs=scene.shs, viewmatrix=cam.viewmatrix,
        projmatrix=cam.projmatrix, campos=cam.campos, tanfovx=cam.tanfovx,
        tanfovy=cam.tanfovy, image_width=w, image_height=h, sh_degree=3,
        sort_order=stt.GlobalSortOrder(order), rect_bounding=True,
        tight_opacity_bounding=True)
    gx, gy = tile_grid(w, h)
    pairs = build_pairs(prep, grid_x=gx, grid_y=gy,
                        sort_order=stt.GlobalSortOrder(order),
                        tile_based_culling=cull)
    rng = np.random.default_rng(1)
    g_color = torch.from_numpy(rng.standard_normal((3, h, w)).astype(np.float32))
    g_t = torch.from_numpy(rng.standard_normal((h, w)).astype(np.float32))
    rows = [x.detach().clone().requires_grad_(True)
            for x in (prep.mean2d, prep.conic_opacity, prep.rgb)]
    cam_args = (prep.cov3d_inv9.detach(), cam.inv_viewprojmatrix, cam.campos)
    kw = dict(k=k, grid_x=gx, grid_y=gy, width=w, height=h)
    return pairs, rows, cam_args, kw, (g_color, g_t)


@pytest.mark.parametrize("k,order,cull", [(1, 0, False), (4, 0, True), (8, 1, True)],
                         ids=["k1", "k4-tilecull", "k8-distance-tilecull"])
def test_plain_backward_matches_autograd(k, order, cull):
    pairs, rows, cam_args, kw, (g_color, g_t) = _autograd_case(k, order, cull)
    color, final_t, n_contrib, _ = blend_kbuffer_forward_plain(
        pairs.gauss_id, pairs.starts, pairs.ends, *rows, *cam_args, **kw)
    assert n_contrib.max() > k  # windows overflow
    expect = torch.autograd.grad((color * g_color).sum() + (final_t * g_t).sum(),
                                 rows)
    d_pair = blend_kbuffer_backward(
        pairs.gauss_id, pairs.starts, pairs.ends, *(r.detach() for r in rows),
        *cam_args, color.detach(), final_t.detach(), n_contrib, g_color, g_t,
        **kw)
    d = reduce_pair_grads(d_pair, pairs.orig_slot, pairs.gauss_offsets)
    for name, got, ref in zip(("xy", "conic_opacity", "rgb"),
                              (d[:, 0:2], d[:, 2:6], d[:, 6:9]), expect):
        scale = ref.abs().amax(dim=0)
        assert (scale > 0).all(), name
        assert ((got - ref).abs() <= 1e-5 * scale).all(), name


def _route_lane_by_lane(acc, commit, src, vals):
    """Each committing lane's terms added into its pair's row of its warp,
    lanes in ascending order (no grouping)."""
    T_tiles, warps = acc.shape[:2]
    commit = commit.reshape(T_tiles, warps, 32)
    src = torch.where(commit, src.reshape(T_tiles, warps, 32), 0)
    vals = vals.reshape(T_tiles, warps, 32, 9)
    t_idx = torch.arange(T_tiles)[:, None]
    w_idx = torch.arange(warps)[None, :]
    for lane in range(32):
        m, s = commit[:, :, lane], src[:, :, lane]
        cur = acc[t_idx, w_idx, s]
        acc[t_idx, w_idx, s] = torch.where(m[..., None],
                                           cur + vals[:, :, lane], cur)


def test_plain_backward_groups_lanes_that_commit_one_pair(monkeypatch):
    pairs, rows, cam_args, kw, (g_color, g_t) = _autograd_case(4, 0, False)
    color, final_t, n_contrib, _ = blend_kbuffer_forward_plain(
        pairs.gauss_id, pairs.starts, pairs.ends, *rows, *cam_args, **kw)
    expect = torch.autograd.grad((color * g_color).sum() + (final_t * g_t).sum(),
                                 rows)
    args = (pairs.gauss_id, pairs.starts, pairs.ends,
            *(r.detach() for r in rows), *cam_args, color.detach(),
            final_t.detach(), n_contrib, g_color, g_t)
    shared = []
    grouped = kbuffer_blend._route_grouped

    def recording(acc, commit, src, vals):
        c = commit.reshape(-1, 32)
        s = torch.where(c, src.reshape(-1, 32), -1)
        same = (s[:, :, None] == s[:, None, :]) & c[:, :, None] & c[:, None, :]
        shared.append(int(same.sum()) - int(c.sum()))  # ordered lane pairs
        grouped(acc, commit, src, vals)

    monkeypatch.setattr(kbuffer_blend, "_route_grouped", recording)
    d_pair = blend_kbuffer_backward(*args, **kw)
    # Steps on which two lanes of a warp committed the same pair.
    assert sum(n > 0 for n in shared) > 10
    d = reduce_pair_grads(d_pair, pairs.orig_slot, pairs.gauss_offsets)
    for name, got, ref in zip(("xy", "conic_opacity", "rgb"),
                              (d[:, 0:2], d[:, 2:6], d[:, 6:9]), expect):
        scale = ref.abs().amax(dim=0)
        assert ((got - ref).abs() <= 1e-5 * scale).all(), name
    monkeypatch.setattr(kbuffer_blend, "_route_grouped", _route_lane_by_lane)
    lane_by_lane = blend_kbuffer_backward(*args, **kw)
    assert not torch.equal(lane_by_lane, d_pair)
    scale = d_pair.abs().amax(dim=0)
    assert ((lane_by_lane - d_pair).abs() <= 1e-5 * scale).all()


def _settings(mod, cam, w, h, as_array, k):
    ext = mod.ExtendedSettings()
    ext.sort_settings.sort_mode = mod.SortMode.PPX_KBUFFER
    ext.sort_settings.queue_sizes.per_pixel = k
    ext.culling_settings.rect_bounding = True
    ext.culling_settings.tight_opacity_bounding = True
    ext.culling_settings.tile_based_culling = True
    return mod.GaussianRasterizationSettings(
        image_height=h, image_width=w, tanfovx=cam.tanfovx,
        tanfovy=cam.tanfovy, bg=as_array(BG), scale_modifier=1.0,
        viewmatrix=as_array(cam.viewmatrix), projmatrix=as_array(cam.projmatrix),
        inv_viewprojmatrix=as_array(cam.inv_viewprojmatrix), sh_degree=3,
        campos=as_array(cam.campos), prefiltered=False, settings=ext,
    )


@pytest.mark.parametrize("path", ["sh-scale-rot", "colors-cov3d"])
def test_api_gradients_match_jax_oracle(path):
    w, h, n, k = 40, 32, 80, 4
    scene = random_scene(8, n, scale_range=(0.03, 0.3), device="cpu")
    cam = make_camera(w, h, device="cpu")
    weights = np.random.default_rng(3).standard_normal((3, h, w)).astype(np.float32)
    means2d = torch.zeros((n, 3))
    if path == "sh-scale-rot":
        inputs = dict(means3D=scene.means3d, means2D=means2d,
                      opacities=scene.opacities[:, None], shs=scene.shs,
                      scales=scene.scales, rotations=scene.rotations)
    else:
        inputs = dict(means3D=scene.means3d, means2D=means2d,
                      opacities=scene.opacities[:, None],
                      colors_precomp=scene.colors,
                      cov3D_precomp=compute_cov3d(scene.scales, 1.0,
                                                  scene.rotations))
    leaves = {key: v.clone().requires_grad_(True) for key, v in inputs.items()}
    color, _ = stt.GaussianRasterizer(
        _settings(stt, cam, w, h, torch.as_tensor, k))(**leaves)
    loss = (color * torch.from_numpy(weights)).sum()
    loss.backward()

    j = lambda x: jnp.asarray(x.numpy())  # noqa: E731

    def jloss(means3d, means2d, opac, *rest):
        if path == "sh-scale-rot":
            kw = dict(shs=rest[0], scales=rest[1], rotations=rest[2])
        else:
            kw = dict(colors_precomp=rest[0], cov3d_precomp=rest[1])
        prep = jax_preprocess(
            means3d, opac.reshape(-1), viewmatrix=j(cam.viewmatrix),
            projmatrix=j(cam.projmatrix), campos=j(cam.campos),
            tanfovx=cam.tanfovx, tanfovy=cam.tanfovy, image_width=w,
            image_height=h, sh_degree=3, rect_bounding=True,
            tight_opacity_bounding=True, **kw)
        # The rasterizer's value-neutral means2D reroute.
        m2d = means2d[:, :2] * jnp.array([0.5 * w, 0.5 * h], jnp.float32)
        prep = prep._replace(mean2d=prep.mean2d + m2d - jax.lax.stop_gradient(m2d))
        img, _, _ = render_kbuffer_naive(
            prep, jnp.asarray(BG), w, h, j(cam.campos),
            j(cam.inv_viewprojmatrix), k=k, tile_based_culling=True)
        return jnp.sum(img * weights)

    names = list(inputs)
    jv, jg = jax.value_and_grad(jloss, argnums=tuple(range(len(names))))(
        *(j(inputs[key]) for key in names))
    np.testing.assert_allclose(float(loss.detach()), float(jv), rtol=1e-5)
    assert leaves["means2D"].grad.abs().max() > 0
    for name, ref in zip(names, jg):
        got, ref = leaves[name].grad.numpy(), np.asarray(ref)
        assert np.isfinite(got).all(), name
        scale = np.abs(ref).max() + 1e-8
        np.testing.assert_allclose(got, ref, atol=3e-4 * scale, rtol=3e-3,
                                   err_msg=f"kbuffer gradient mismatch for {name}")


def _static(mod, cam, as_array, size):
    ext = mod.ExtendedSettings()
    ext.sort_settings.sort_mode = mod.SortMode.PPX_KBUFFER
    ext.culling_settings.rect_bounding = True
    ext.culling_settings.tight_opacity_bounding = True
    ext.culling_settings.tile_based_culling = True
    return mod.GaussianRasterizationSettings(
        image_height=size, image_width=size, tanfovx=cam.tanfovx,
        tanfovy=cam.tanfovy, bg=as_array(np.zeros(3, np.float32)),
        scale_modifier=1.0, viewmatrix=as_array(cam.viewmatrix),
        projmatrix=as_array(cam.projmatrix),
        inv_viewprojmatrix=as_array(cam.inv_viewprojmatrix), sh_degree=3,
        campos=as_array(cam.campos), prefiltered=False, settings=ext,
    )


def test_train_step_matches_jax():
    size, n = 32, 60
    cam = make_camera(size, size, device="cpu")
    j = lambda x: jnp.asarray(np.asarray(x))  # noqa: E731
    jstatic = _static(stopthepop_tpu, cam, j, size)
    assert jstatic.settings.sort_settings.sort_mode == JMode.PPX_KBUFFER
    jmodel = jax_init_random(jax.random.PRNGKey(1), n, extent=1.0)
    params = {key: np.asarray(v) for key, v in jmodel._asdict().items()}
    target = np.random.default_rng(2).uniform(0, 1, (3, size, size)).astype(np.float32)
    jopt = jtrainer.make_3dgs_optimizer(1.3, position_lr_max_steps=100)
    jstep = jax.jit(jtrainer.make_train_step(
        jopt, static=jstatic, pair_capacity=4096, interpret=True))
    jcam = jtrainer.CameraArrays(j(cam.viewmatrix), j(cam.projmatrix),
                                 j(cam.inv_viewprojmatrix), j(cam.campos))
    _, _, jaux = jstep(jtrainer.init_train_state(jmodel, jopt), jcam,
                       jnp.asarray(target), jtrainer.init_densify_stats(n))

    model = from_numpy_params(params, device="cpu")
    state = init_train_state(model, make_3dgs_optimizer(
        model, 1.3, position_lr_max_steps=100))
    step = make_train_step(static=_static(stt, cam, torch.as_tensor, size))
    tcam = CameraArrays(cam.viewmatrix, cam.projmatrix, cam.inv_viewprojmatrix,
                        cam.campos)
    state, stats, aux = step(state, tcam, torch.from_numpy(target),
                             init_densify_stats(n))
    np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]),
                               rtol=1e-4)
    assert state.step == 1 and int(stats.denom.sum()) > 0
    for name in ("means3d", "opacity_logit", "sh_dc"):
        g = getattr(model, name).grad
        assert torch.isfinite(g).all() and g.abs().max() > 0, name


def test_train_cli_runs_kbuffer(tmp_path):
    gt, _ = structured_scene(400, 0, device="cpu")
    write_nerf_synthetic(str(tmp_path), gt, views=2, size=24, device="cpu")
    res = cli.main(["--data", str(tmp_path), "--iters", "4",
                    "--init-points", "150", "--eval-every", "2",
                    "--densify-from", "100", "--sort-mode", "PPX_KBUFFER",
                    "--device", "cpu"])
    assert res.state.step == 4
    assert sorted(res.eval_psnr) == [2, 4]
    assert all(np.isfinite(v) for v in res.eval_psnr.values())


def test_empty_stream_gives_background_and_no_gradient():
    w, h = 40, 24
    gx, gy = tile_grid(w, h)
    cam = make_camera(w, h, device="cpu")
    empty = torch.zeros(0, dtype=torch.int32)
    ranges = torch.zeros(gx * gy, dtype=torch.int32)
    rows = (torch.zeros(5, 2), torch.zeros(5, 4), torch.zeros(5, 3),
            torch.zeros(5, 9), cam.inv_viewprojmatrix, cam.campos)
    kw = dict(k=4, grid_x=gx, grid_y=gy, width=w, height=h)
    color, final_t, n_contrib, depth_acc = blend_kbuffer_forward_plain(
        empty, ranges, ranges, *rows, **kw)
    assert (color == 0).all() and (final_t == 1).all()
    assert (n_contrib == 0).all() and (depth_acc == 0).all()
    d_pair = blend_kbuffer_backward(
        empty, ranges, ranges, *rows, color, final_t, n_contrib,
        torch.ones(3, h, w), torch.ones(h, w), **kw)
    assert d_pair.shape == (0, 9)
