"""The port's batched training step (train/trainer.py::make_batched_train_step)
against the JAX package's, on the CPU.

One scene, B = 2 cameras and seeded random targets go through JAX's
``jit(make_batched_train_step(..., interpret=True))`` with the JAX 3DGS
optimizer and through the port's step, for three steps:

- losses at rtol 1e-4 (as test_torch_train.py's single-camera steps);
- parameters after each step: at least 99% of each tensor's elements
  within 1e-5 of its group's learning rate per step taken (the tolerance
  of test_torch_train.py's Adam test, each update being about
  lr * sign(grad)) plus one float32 rounding of the parameter per step
  (that test starts from zero; adding an update of ~1e-4 into a value of
  ~0.5 rounds it by up to 3e-8, more than 1e-5 of the means' learning
  rate), and every element within 2e-3 of the learning rate per step. The
  two packages sum the blend gradients in different orders (~1e-6 apart),
  and Adam's m / sqrt(v) turns that into up to ~1.2e-3 lr on the few
  elements whose gradients nearly cancel (3 of 720 sh_rest and 1 of 180
  means coordinates here);
- ``denom`` and ``max_radii`` exactly; ``grad2d_accum`` at
  test_torch_train.py's tolerance.

And the port's batched gradient is the mean of its own single-camera
gradients, within 1e-5 of each tensor's largest value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from stopthepop_tpu.config import ExtendedSettings as JExt
from stopthepop_tpu.config import GaussianRasterizationSettings as JSettings
from stopthepop_tpu.models.gaussians import init_random as jax_init_random
from stopthepop_tpu.train import trainer as jtrainer

from stopthepop_tpu_torch.config import ExtendedSettings, GaussianRasterizationSettings
from stopthepop_tpu_torch.io.cameras import CameraArrays
from stopthepop_tpu_torch.models.gaussians import PARAM_NAMES, from_numpy_params
from stopthepop_tpu_torch.train.trainer import (
    init_densify_stats,
    init_train_state,
    make_3dgs_optimizer,
    make_batched_train_step,
    step_forward,
)
from stopthepop_tpu_torch.utils.testing import make_camera, one_thread_under_xdist

one_thread_under_xdist()

SIZE = 32
B = 2
N = 60
POSITIONS = ((0.0, 0.0, -4.0), (0.35, -0.25, -4.3))


def _params():
    m = jax_init_random(jax.random.PRNGKey(1), N, extent=1.0)
    return m, {k: np.asarray(v) for k, v in m._asdict().items()}


def _culling(ext_cls):
    ext = ext_cls()
    ext.culling_settings.rect_bounding = True
    ext.culling_settings.tight_opacity_bounding = True
    ext.culling_settings.tile_based_culling = True
    return ext


def _static(settings_cls, cam, as_array, ext):
    return settings_cls(
        image_height=SIZE, image_width=SIZE, tanfovx=cam.tanfovx,
        tanfovy=cam.tanfovy, bg=as_array(np.zeros(3, np.float32)),
        scale_modifier=1.0, viewmatrix=None, projmatrix=None,
        inv_viewprojmatrix=None, sh_degree=3, campos=None, prefiltered=False,
        settings=ext,
    )


def _cams():
    cams = [make_camera(SIZE, SIZE, campos=p, device="cpu") for p in POSITIONS]
    fields = [torch.stack([getattr(c, f) for c in cams])
              for f in ("viewmatrix", "projmatrix", "inv_viewprojmatrix",
                        "campos")]
    return cams[0], CameraArrays(*fields)


def _targets():
    rng = np.random.default_rng(2)
    return rng.uniform(0, 1, (B, 3, SIZE, SIZE)).astype(np.float32)


def test_three_batched_steps_match_jax():
    cam0, tcams = _cams()
    j = lambda x: jnp.asarray(np.asarray(x))  # noqa: E731
    jstatic = _static(JSettings, cam0, j, _culling(JExt))
    static = _static(GaussianRasterizationSettings, cam0, torch.as_tensor,
                     _culling(ExtendedSettings))
    jmodel, params = _params()
    targets = _targets()
    jopt = jtrainer.make_3dgs_optimizer(1.3, position_lr_max_steps=100)
    jstep = jax.jit(jtrainer.make_batched_train_step(
        jopt, static=jstatic, pair_capacity=4096, interpret=True))
    jstate = jtrainer.init_train_state(jmodel, jopt)
    jstats = jtrainer.init_densify_stats(N)
    jcams = jtrainer.CameraArrays(*(j(x) for x in tcams))

    model = from_numpy_params(params, device="cpu")
    opt = make_3dgs_optimizer(model, 1.3, position_lr_max_steps=100)
    state = init_train_state(model, opt)
    stats = init_densify_stats(N)
    step = make_batched_train_step(static=static)
    tol = {k: 0.0 for k in PARAM_NAMES}
    for i in range(3):
        jstate, jstats, jaux = jstep(jstate, jcams, jnp.asarray(targets), jstats)
        state, stats, aux = step(state, tcams, torch.from_numpy(targets), stats)
        np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]),
                                   rtol=1e-4, err_msg=f"step {i}")
        assert len(aux["num_rendered"]) == B and min(aux["num_rendered"]) > 0
        lrs = {g["params"][0].data_ptr(): g["lr"] for g in opt.param_groups}
        for k in PARAM_NAMES:
            p = getattr(model, k)
            tol[k] += 1e-5 * lrs[p.data_ptr()]
            ref = np.asarray(getattr(jstate.model, k))
            err = np.abs(p.detach().numpy() - ref)
            bound = tol[k] + (i + 1) * np.spacing(np.abs(ref))
            assert (err <= bound).mean() >= 0.99, (
                f"{k} step {i}: {int((err > bound).sum())} of {err.size}")
            assert (err <= (i + 1) * 2e-3 * lrs[p.data_ptr()]).all(), (
                f"{k} step {i}: {float(err.max())}")
    assert state.step == 3
    np.testing.assert_array_equal(stats.denom.numpy(), np.asarray(jstats.denom))
    np.testing.assert_array_equal(stats.max_radii.numpy(),
                                  np.asarray(jstats.max_radii))
    assert int(stats.denom.max()) == 3 * B  # seen by both cameras each step
    np.testing.assert_allclose(stats.grad2d_accum.numpy(),
                               np.asarray(jstats.grad2d_accum), rtol=2e-3,
                               atol=2e-4 * float(np.abs(jstats.grad2d_accum).max()))


def test_batched_gradient_is_the_mean_of_single_camera_gradients():
    cam0, tcams = _cams()
    static = _static(GaussianRasterizationSettings, cam0, torch.as_tensor,
                     _culling(ExtendedSettings))
    _, params = _params()
    targets = torch.from_numpy(_targets())

    model = from_numpy_params(params, device="cpu")
    state = init_train_state(model, make_3dgs_optimizer(model, 1.3))
    single = {k: torch.zeros_like(getattr(model, k)) for k in PARAM_NAMES}
    for b in range(B):
        state.optimizer.zero_grad(set_to_none=True)
        cam = CameraArrays(*(x[b] for x in tcams))
        loss, _, _ = step_forward(state, cam, targets[b], static=static)
        loss.backward()
        for k in PARAM_NAMES:
            single[k] += getattr(model, k).grad / B

    model = from_numpy_params(params, device="cpu")
    state = init_train_state(model, make_3dgs_optimizer(model, 1.3))
    make_batched_train_step(static=static)(state, tcams, targets,
                                           init_densify_stats(N))
    for k in PARAM_NAMES:
        ref = single[k]
        assert float(ref.abs().max()) > 0, k
        torch.testing.assert_close(getattr(model, k).grad, ref, rtol=0,
                                   atol=1e-5 * float(ref.abs().max()), msg=k)
