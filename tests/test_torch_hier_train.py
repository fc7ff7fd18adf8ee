"""Training in the port's HIERARCHICAL mode (kernels K5 and K6, their plain
versions here) against the JAX package, on the CPU.

- One training step in HIER against the JAX ``make_train_step`` (its Pallas
  kernels K5 and K6 in interpret mode): loss at rtol 1e-4, as the k-buffer
  step test holds it. One 16x16 tile and queues (8, 4, 2) keep the
  interpret-mode backward cheap.
- The training CLI with ``--sort-mode HIER`` for a few iterations, and at
  its default sort mode, which is HIER as in the JAX CLI.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import stopthepop_tpu
from stopthepop_tpu.config import SortMode as JMode
from stopthepop_tpu.models.gaussians import init_random as jax_init_random
from stopthepop_tpu.train import trainer as jtrainer

import stopthepop_tpu_torch as stt
from stopthepop_tpu_torch.io.cameras import CameraArrays
from stopthepop_tpu_torch.kernels import hier_blend
from stopthepop_tpu_torch.models.gaussians import PARAM_NAMES, from_numpy_params
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
)

one_thread_under_xdist()

QUEUES = (8, 4, 2)


def _static(mod, cam, as_array, size):
    ext = mod.ExtendedSettings()
    ext.sort_settings.sort_mode = mod.SortMode.HIER
    q = ext.sort_settings.queue_sizes
    q.tile_4x4, q.tile_2x2, q.per_pixel = QUEUES
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
    size, n = 16, 40
    cam = make_camera(size, size, device="cpu")
    j = lambda x: jnp.asarray(np.asarray(x))  # noqa: E731
    jstatic = _static(stopthepop_tpu, cam, j, size)
    assert jstatic.settings.sort_settings.sort_mode == JMode.HIER
    jmodel = jax_init_random(jax.random.PRNGKey(1), n, extent=1.0)
    params = {key: np.asarray(v) for key, v in jmodel._asdict().items()}
    target = np.random.default_rng(2).uniform(0, 1, (3, size, size)).astype(np.float32)
    jopt = jtrainer.make_3dgs_optimizer(1.3, position_lr_max_steps=100)
    jstep = jax.jit(jtrainer.make_train_step(
        jopt, static=jstatic, pair_capacity=1024, interpret=True))
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
    # The densification statistics read the means2D dummy's gradient,
    # which flows through K6's xy column.
    assert state.step == 1 and int(stats.denom.sum()) > 0
    assert float(stats.grad2d_accum.max()) > 0
    for name in PARAM_NAMES:
        g = getattr(model, name).grad
        assert g is not None and torch.isfinite(g).all(), name
    for name in ("means3d", "opacity_logit", "sh_dc", "scales_log"):
        assert getattr(model, name).grad.abs().max() > 0, name


def test_train_cli_runs_hier(tmp_path):
    gt, _ = structured_scene(400, 0, device="cpu")
    write_nerf_synthetic(str(tmp_path), gt, views=2, size=24, device="cpu")
    before = hier_blend.blend_hier_backward.launches
    res = cli.main(["--data", str(tmp_path), "--iters", "4",
                    "--init-points", "150", "--eval-every", "2",
                    "--densify-from", "100", "--sort-mode", "HIER",
                    "--device", "cpu"])
    assert res.state.step == 4
    assert sorted(res.eval_psnr) == [2, 4]
    assert all(np.isfinite(v) for v in res.eval_psnr.values())
    assert hier_blend.blend_hier_backward.launches == before  # plain on CPU
    assert torch.isfinite(res.state.model.means3d).all()
    # HIER is the default, as in the JAX CLI.
    again = cli.main(["--data", str(tmp_path), "--iters", "1",
                      "--init-points", "150", "--eval-every", "1",
                      "--densify-from", "100", "--device", "cpu"])
    assert again.state.step == 1
    assert float(again.eval_psnr[1]) == float(cli.main([
        "--data", str(tmp_path), "--iters", "1", "--init-points", "150",
        "--eval-every", "1", "--densify-from", "100", "--sort-mode", "HIER",
        "--device", "cpu"]).eval_psnr[1])
