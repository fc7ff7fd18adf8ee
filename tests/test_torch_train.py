"""The port's training step and its parts against the JAX package's, on the CPU.

- L1, SSIM, L1 + D-SSIM and PSNR, values and gradients, at rtol 1e-5 (the
  same float32 operations in the same order);
- the position-LR schedule (float64 here, float32 in JAX: rtol 1e-6);
- one per-group Adam update, then a second, from identical gradients against
  optax within 1e-5 of each group's learning rate: optax forms its bias
  corrections in float32 (1 - 0.999 rounds 1.3e-5 off), torch in float64;
- 3 train steps against JAX ``make_train_step`` (its Pallas kernels in
  interpret mode): losses at rtol 1e-4;
- the loss falls by 30% in 25 steps (tests/test_train.py's check);
- the progressive SH mask.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stopthepop_tpu.config import ExtendedSettings as JExt
from stopthepop_tpu.config import GaussianRasterizationSettings as JSettings
from stopthepop_tpu.models.gaussians import init_random as jax_init_random
from stopthepop_tpu.train import loss as jloss
from stopthepop_tpu.train import trainer as jtrainer

from stopthepop_tpu_torch.config import ExtendedSettings, GaussianRasterizationSettings
from stopthepop_tpu_torch.io.cameras import CameraArrays
from stopthepop_tpu_torch.models.gaussians import from_numpy_params
from stopthepop_tpu_torch.train import loss as tloss
from stopthepop_tpu_torch.train.trainer import (
    active_sh_mask,
    init_densify_stats,
    init_train_state,
    make_3dgs_optimizer,
    make_train_step,
    position_lr_schedule,
    render_model,
    set_position_lr,
)
from stopthepop_tpu_torch.utils.testing import (
    make_camera,
    one_thread_under_xdist,
)

one_thread_under_xdist()

SIZE = 32


def _images(seed=0, size=SIZE):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (3, size, size)).astype(np.float32)
    b = np.clip(a + 0.2 * rng.standard_normal(a.shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("name", ["l1_loss", "ssim", "rgb_loss", "psnr"])
def test_losses_and_their_gradients_match_jax(name):
    a, b = _images()
    jv, jg = jax.value_and_grad(getattr(jloss, name))(jnp.asarray(a), jnp.asarray(b))
    x = torch.from_numpy(a).requires_grad_(True)
    v = getattr(tloss, name)(x, torch.from_numpy(b))
    v.backward()
    np.testing.assert_allclose(float(v.detach()), float(jv), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(jg)).max())


def test_ssim_identity_and_range():
    a, b = _images(1)
    a, b = torch.from_numpy(a), torch.from_numpy(b)
    assert float(tloss.ssim(a, a)) > 0.999
    assert -1.0 <= float(tloss.ssim(a, b)) < 0.9
    assert float(tloss.rgb_loss(a, a)) < 1e-5
    assert float(tloss.psnr(a, a)) > 80


def test_position_lr_schedule_matches_jax():
    kw = dict(lr_init=1.6e-4, lr_final=1.6e-6, lr_delay_mult=0.01,
              max_steps=1000, spatial_lr_scale=1.3)
    for delay in (0, 100):
        ours = position_lr_schedule(**kw, lr_delay_steps=delay)
        ref = jtrainer.position_lr_schedule(**kw, lr_delay_steps=delay)
        for step in (0, 1, 50, 500, 999, 1000, 5000):
            np.testing.assert_allclose(ours(step), float(ref(jnp.int32(step))),
                                       rtol=1e-6, err_msg=f"step {step}")


def _params(n=30, seed=0):
    m = jax_init_random(jax.random.PRNGKey(seed), n, extent=1.0)
    return m, {k: np.asarray(v) for k, v in m._asdict().items()}


def test_adam_updates_match_optax():
    # Parameters start at zero, so each parameter is the sum of its updates
    # and the comparison is not blurred by rounding into large values. Each
    # update is about lr * sign(grad); the two Adams differ by the float32
    # rounding of optax's bias corrections, ~6.4e-6 of it.
    jmodel, params = _params()
    params = {k: np.zeros_like(v) for k, v in params.items()}
    jmodel = type(jmodel)(**{k: jnp.asarray(v) for k, v in params.items()})
    model = from_numpy_params(params, device="cpu")
    opt = make_3dgs_optimizer(model, 1.3, position_lr_max_steps=100)
    jopt = jtrainer.make_3dgs_optimizer(1.3, position_lr_max_steps=100)
    jstate = jopt.init(jmodel)
    rng = np.random.default_rng(5)
    tol = {k: 0.0 for k in params}
    for step in range(2):
        grads = {k: (rng.standard_normal(v.shape) * 10.0 ** rng.uniform(-6, 0, v.shape))
                 .astype(np.float32) for k, v in params.items()}
        jgrads = type(jmodel)(**{k: jnp.asarray(v) for k, v in grads.items()})
        updates, jstate = jopt.update(jgrads, jstate, jmodel)
        jmodel = optax.apply_updates(jmodel, updates)
        for k, v in grads.items():
            getattr(model, k).grad = torch.from_numpy(v)
        set_position_lr(opt, step)
        opt.step()
        lrs = {g["params"][0].data_ptr(): g["lr"] for g in opt.param_groups}
        for k in params:
            p = getattr(model, k)
            got = p.detach().numpy()
            assert np.abs(got).max() > 0.5 * lrs[p.data_ptr()], k
            tol[k] += 1e-5 * lrs[p.data_ptr()]
            np.testing.assert_allclose(got, np.asarray(getattr(jmodel, k)),
                                       rtol=0, atol=tol[k],
                                       err_msg=f"{k} step {step}")


def _static(settings_cls, cam, as_array, ext):
    return settings_cls(
        image_height=SIZE, image_width=SIZE, tanfovx=cam.tanfovx,
        tanfovy=cam.tanfovy, bg=as_array(np.zeros(3, np.float32)),
        scale_modifier=1.0, viewmatrix=as_array(cam.viewmatrix),
        projmatrix=as_array(cam.projmatrix),
        inv_viewprojmatrix=as_array(cam.inv_viewprojmatrix), sh_degree=3,
        campos=as_array(cam.campos), prefiltered=False, settings=ext,
    )


def _culling(ext_cls):
    ext = ext_cls()
    ext.culling_settings.rect_bounding = True
    ext.culling_settings.tight_opacity_bounding = True
    ext.culling_settings.tile_based_culling = True
    return ext


def test_three_train_steps_match_jax():
    cam = make_camera(SIZE, SIZE, device="cpu")
    j = lambda x: jnp.asarray(np.asarray(x))  # noqa: E731
    jstatic = _static(JSettings, cam, j, _culling(JExt))
    static = _static(GaussianRasterizationSettings, cam, torch.as_tensor,
                     _culling(ExtendedSettings))
    jmodel, params = _params(60, seed=1)
    target = np.random.default_rng(2).uniform(0, 1, (3, SIZE, SIZE)).astype(np.float32)
    jopt = jtrainer.make_3dgs_optimizer(1.3, position_lr_max_steps=100)
    jstep = jax.jit(jtrainer.make_train_step(
        jopt, static=jstatic, pair_capacity=4096, sh_ramp_every=2,
        interpret=True))
    jstate = jtrainer.init_train_state(jmodel, jopt)
    jstats = jtrainer.init_densify_stats(60)
    jcam = jtrainer.CameraArrays(j(cam.viewmatrix), j(cam.projmatrix),
                                 j(cam.inv_viewprojmatrix), j(cam.campos))

    model = from_numpy_params(params, device="cpu")
    opt = make_3dgs_optimizer(model, 1.3, position_lr_max_steps=100)
    state = init_train_state(model, opt)
    stats = init_densify_stats(60)
    step = make_train_step(static=static, sh_ramp_every=2)
    tcam = CameraArrays(cam.viewmatrix, cam.projmatrix, cam.inv_viewprojmatrix,
                        cam.campos)
    for i in range(3):
        jstate, jstats, jaux = jstep(jstate, jcam, jnp.asarray(target), jstats)
        state, stats, aux = step(state, tcam, torch.from_numpy(target), stats)
        np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]),
                                   rtol=1e-4, err_msg=f"step {i}")
    assert state.step == 3
    np.testing.assert_array_equal(stats.denom.numpy(), np.asarray(jstats.denom))
    np.testing.assert_array_equal(stats.max_radii.numpy(),
                                  np.asarray(jstats.max_radii))
    np.testing.assert_allclose(stats.grad2d_accum.numpy(),
                               np.asarray(jstats.grad2d_accum), rtol=2e-3,
                               atol=2e-4 * float(np.abs(jstats.grad2d_accum).max()))


def test_training_decreases_loss():
    cam = make_camera(SIZE, SIZE, device="cpu")
    static = _static(GaussianRasterizationSettings, cam, torch.as_tensor,
                     ExtendedSettings())
    tcam = CameraArrays(cam.viewmatrix, cam.projmatrix, cam.inv_viewprojmatrix,
                        cam.campos)
    _, params = _params(60)
    gt = from_numpy_params(params, device="cpu")
    with torch.no_grad():
        target, _ = render_model(gt, tcam, static=static)
    rng = np.random.default_rng(2)
    params["means3d"] = params["means3d"] + 0.05 * rng.standard_normal(
        params["means3d"].shape).astype(np.float32)
    params["opacity_logit"] = params["opacity_logit"] - 0.5
    model = from_numpy_params(params, device="cpu")
    state = init_train_state(model, torch.optim.Adam(model.parameters(), lr=5e-3,
                                                     eps=1e-15))
    stats = init_densify_stats(60)
    step = make_train_step(static=static)
    losses = []
    for _ in range(25):
        state, stats, aux = step(state, tcam, target, stats)
        losses.append(float(aux["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.7, losses
    assert int(stats.denom.max()) == 25
    assert float(stats.grad2d_accum.max()) > 0.0
    assert int(stats.max_radii.max()) > 0


def test_active_sh_mask_matches_jax():
    for degree in range(4):
        np.testing.assert_array_equal(
            active_sh_mask(degree, 15).numpy(),
            np.asarray(jtrainer.active_sh_mask(jnp.int32(degree), 15)))
    assert active_sh_mask(2, 15)[:, 0].tolist() == [1.0] * 8 + [0.0] * 7
