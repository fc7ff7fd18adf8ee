"""Single-camera 3DGS training step (torch).

Port of ``stopthepop_tpu/train/trainer.py``: render through the public API,
L1 + D-SSIM loss, per-group Adam, plus the densification statistics the
upstream trainer reads (radii and the norm of the means2D dummy's gradient,
the NDC-scaled screen-space mean gradient).

The JAX step is a pure function of (state, cam, target, stats); here the
model's parameters and the optimizer's moments are updated in place, and the
step returns a new ``TrainState`` (the same model and optimizer, the step
count plus one) and new ``DensifyStats``. ``make_batched_train_step`` takes
one step on the mean loss over a batch of cameras.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..config import GaussianRasterizationSettings
from ..io.cameras import CameraArrays
from ..models.gaussians import GaussianModel
from ..render.cli import render_model  # noqa: F401  (re-exported, as in JAX)
from ..render.rasterize import rasterize_gaussians
from ..utils.profiling import span
from .loss import rgb_loss

# Parameter groups of the 3DGS optimizer: (group name, model parameter).
GROUPS = (("means", "means3d"), ("scales", "scales_log"), ("rot", "rotations"),
          ("opacity", "opacity_logit"), ("dc", "sh_dc"), ("rest", "sh_rest"))


class TrainState(NamedTuple):
    model: GaussianModel
    optimizer: torch.optim.Optimizer
    step: int


class DensifyStats(NamedTuple):
    """Running stats the densification controller consumes."""

    grad2d_accum: torch.Tensor  # [P] sum of ||dL/dmean2D_ndc|| over steps
    denom: torch.Tensor         # [P] int32 steps the Gaussian was visible
    max_radii: torch.Tensor     # [P] int32 max screen radius seen


def init_densify_stats(num_gaussians: int, device=None) -> DensifyStats:
    return DensifyStats(
        grad2d_accum=torch.zeros((num_gaussians,), dtype=torch.float32,
                                 device=device),
        denom=torch.zeros((num_gaussians,), dtype=torch.int32, device=device),
        max_radii=torch.zeros((num_gaussians,), dtype=torch.int32,
                              device=device),
    )


def make_optimizer(params, lr: float = 1e-3) -> torch.optim.Adam:
    """Plain Adam over ``params``: the JAX package's ``make_optimizer``
    (``optax.adam(lr, eps=1e-15)``), as the sharded steps use it."""
    return torch.optim.Adam(params, lr=lr, eps=1e-15)


def position_lr_schedule(
    lr_init: float = 1.6e-4,
    lr_final: float = 1.6e-6,
    lr_delay_mult: float = 0.01,
    lr_delay_steps: int = 0,
    max_steps: int = 30_000,
    spatial_lr_scale: float = 1.0,
):
    """The upstream 3DGS exponential position-LR schedule (log-lerp), as a
    function of the step count (Python floats)."""

    def schedule(step):
        t = min(max(step / max_steps, 0.0), 1.0)
        log_lerp = math.exp(
            math.log(lr_init * spatial_lr_scale) * (1 - t)
            + math.log(lr_final * spatial_lr_scale) * t
        )
        if lr_delay_steps > 0:
            delay = lr_delay_mult + (1 - lr_delay_mult) * math.sin(
                0.5 * math.pi * min(max(step / lr_delay_steps, 0.0), 1.0)
            )
        else:
            delay = 1.0
        return delay * log_lerp

    return schedule


def make_3dgs_optimizer(
    model: GaussianModel,
    spatial_lr_scale: float = 1.0,
    *,
    position_lr_init: float = 1.6e-4,
    position_lr_final: float = 1.6e-6,
    position_lr_max_steps: int = 30_000,
    feature_lr: float = 2.5e-3,
    opacity_lr: float = 0.025,
    scaling_lr: float = 5e-3,
    rotation_lr: float = 1e-3,
):
    """Per-parameter-group Adam with the upstream 3DGS trainer's defaults
    (means: exp-decayed LR scaled by the scene extent; SH rest at
    feature_lr / 20). The means group keeps its schedule's parameters as
    plain numbers (``"schedule"``), so the optimizer's state_dict holds
    them; ``set_position_lr`` applies it."""
    lrs = {"scales": scaling_lr, "rot": rotation_lr, "opacity": opacity_lr,
           "dc": feature_lr, "rest": feature_lr / 20.0}
    schedule = dict(lr_init=position_lr_init, lr_final=position_lr_final,
                    max_steps=position_lr_max_steps,
                    spatial_lr_scale=spatial_lr_scale)
    groups = [{"params": [model.means3d], "name": "means",
               "lr": position_lr_schedule(**schedule)(0),
               "schedule": schedule}]
    groups += [{"params": [getattr(model, p)], "name": g, "lr": lrs[g]}
               for g, p in GROUPS[1:]]
    return torch.optim.Adam(groups, eps=1e-15)


def set_position_lr(optimizer: torch.optim.Optimizer, step: int) -> None:
    """Set each scheduled group's LR for the update that follows step
    ``step`` updates (optax evaluates its schedule at the count before the
    update)."""
    for group in optimizer.param_groups:
        if "schedule" in group:
            group["lr"] = position_lr_schedule(**group["schedule"])(step)


# SH band of each rest-coefficient (coeffs 1..15): degree l covers indices
# [l^2, (l+1)^2).
_SH_REST_BAND = (1,) * 3 + (2,) * 5 + (3,) * 7


def active_sh_mask(active_degree: int, n_rest: int = 15, device=None):
    """[n_rest, 1] mask over sh_rest coefficients for an active degree — the
    upstream trainer's progressive oneupSHdegree schedule: inactive bands
    render as zero and receive zero gradient."""
    bands = torch.tensor(_SH_REST_BAND[:n_rest], device=device)
    return (bands <= active_degree).to(torch.float32)[:, None]


def init_train_state(model: GaussianModel, optimizer) -> TrainState:
    return TrainState(model, optimizer, 0)


def means2d_leaf(model: GaussianModel) -> torch.Tensor:
    """The means2D dummy [P, 2]: a zero leaf whose gradient the
    densification statistics read."""
    return torch.zeros((model.num_gaussians, 2), dtype=torch.float32,
                       device=model.means3d.device, requires_grad=True)


def step_forward(state: TrainState, cam: CameraArrays, target, *,
                 static: GaussianRasterizationSettings,
                 lambda_dssim: float = 0.2, sh_ramp_every: int = 0,
                 means2d_dummy=None, render_kwargs=None):
    """The step's forward stage: render (kernel K1, K3 in PPX_KBUFFER, K5 in
    HIER) and L1 + D-SSIM. ``render_kwargs`` go to ``rasterize_gaussians``
    (e.g. ``tile_shape``).

    Returns (loss, RenderOutput, means2d_dummy): the dummy (a new
    ``means2d_leaf`` unless one is given) is the leaf whose gradient the
    densification statistics read."""
    with span("forward"):
        model = state.model
        if means2d_dummy is None:
            means2d_dummy = means2d_leaf(model)
        with span("params"):
            if sh_ramp_every:
                active = min(state.step // sh_ramp_every,
                             int(static.sh_degree))
                mask = active_sh_mask(active, model.sh_rest.shape[1],
                                      model.sh_rest.device)
                shs = torch.cat([model.sh_dc, model.sh_rest * mask], dim=1)
            else:
                shs = model.shs()
            opacities, scales = model.opacities(), model.scales()
            rotations = model.rotations_normalized()
        rs = static._replace(
            viewmatrix=cam.viewmatrix, projmatrix=cam.projmatrix,
            inv_viewprojmatrix=cam.inv_viewprojmatrix, campos=cam.campos,
        )
        out = rasterize_gaussians(
            model.means3d, means2d_dummy, shs, None, opacities, scales,
            rotations, None, rs, full_output=True, **(render_kwargs or {}),
        )
        with span("loss"):
            loss = rgb_loss(out.color, target, lambda_dssim)
        return loss, out, means2d_dummy


def step_backward(state: TrainState, loss) -> None:
    """The step's backward stage: fresh gradients of every parameter (the
    blend's through kernel K2, K4 in PPX_KBUFFER, K6 in HIER)."""
    with span("backward"):
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()


def step_update(state: TrainState) -> TrainState:
    """The step's optimizer stage: the scheduled LRs at the step count
    before the update, then one Adam update in place."""
    with span("update"):
        set_position_lr(state.optimizer, state.step)
        state.optimizer.step()
        return state._replace(step=state.step + 1)


def update_densify_stats(stats: DensifyStats, out, means2d_dummy):
    visible = out.radii > 0
    g2d_norm = torch.linalg.norm(means2d_dummy.grad, dim=-1)
    return DensifyStats(
        grad2d_accum=stats.grad2d_accum + torch.where(visible, g2d_norm, 0.0),
        denom=stats.denom + visible.to(torch.int32),
        max_radii=torch.maximum(stats.max_radii, out.radii),
    )


def make_train_step(
    *,
    static: GaussianRasterizationSettings,
    lambda_dssim: float = 0.2,
    sh_ramp_every: int = 0,
    render_kwargs=None,
):
    """Returns (state, cam, target, stats) -> (state, stats, aux).

    ``sh_ramp_every > 0`` enables the upstream trainer's progressive SH
    schedule (one more band every N steps, up to ``static.sh_degree``).
    ``render_kwargs`` pass extra rasterize options through (``tile_shape``:
    the JAX package's GLOBAL-mode training default is (32, 16)).
    ``aux`` holds the loss as a 0-d tensor (read it with ``float`` only
    where the host needs it: that waits for the device)."""

    def train_step(state: TrainState, cam: CameraArrays, target, stats):
        loss, out, means2d_dummy = step_forward(
            state, cam, target, static=static, lambda_dssim=lambda_dssim,
            sh_ramp_every=sh_ramp_every, render_kwargs=render_kwargs)
        step_backward(state, loss)
        state = step_update(state)
        stats = update_densify_stats(stats, out, means2d_dummy)
        aux = {"loss": loss.detach(), "num_rendered": out.num_rendered}
        return state, stats, aux

    return train_step


def make_batched_train_step(
    *,
    static: GaussianRasterizationSettings,
    lambda_dssim: float = 0.2,
    render_kwargs=None,
):
    """Like make_train_step, but over a BATCH of cameras per step.

    Returns (state, cams, targets, stats) -> (state, stats, aux): ``cams``
    is a CameraArrays whose tensors carry a leading batch axis B, and
    ``targets`` is [B, 3, H, W]. The loss is the mean over cameras, so the
    gradients are the mean of the per-camera gradients. The cameras are
    rendered one after the other, and each one's ``(loss_b / B).backward()``
    adds its share to the gradients before the next is rendered: the same
    gradients as one backward of the mean, with one frame's activations in
    memory at a time. All B renders share one means2D dummy, so its
    gradient is the batch-mean gradient, as JAX's shared ``m2d`` under
    ``vmap``. Densify stats accumulate per-camera visibility and that
    gradient scaled back by B, like B single-camera steps. No progressive
    SH schedule, as in the JAX batched step. ``aux`` holds the mean loss (a
    0-d tensor) and each camera's pair count. ``render_kwargs`` as in
    make_train_step.
    """

    def train_step(state: TrainState, cams: CameraArrays, targets, stats):
        B = targets.shape[0]
        means2d_dummy = means2d_leaf(state.model)
        state.optimizer.zero_grad(set_to_none=True)
        losses, radii, num_rendered = [], [], []
        for b in range(B):
            cam = CameraArrays(*(x[b] for x in cams))
            loss, out, _ = step_forward(
                state, cam, targets[b], static=static,
                lambda_dssim=lambda_dssim, means2d_dummy=means2d_dummy,
                render_kwargs=render_kwargs)
            (loss / B).backward()
            losses.append(loss.detach())
            radii.append(out.radii)
            num_rendered.append(out.num_rendered)
        state = step_update(state)

        n_vis = (torch.stack(radii) > 0).sum(dim=0)
        g2d_norm = torch.linalg.norm(means2d_dummy.grad, dim=-1)
        stats = DensifyStats(
            grad2d_accum=stats.grad2d_accum
            + torch.where(n_vis > 0, g2d_norm * B, 0.0),
            denom=stats.denom + n_vis.to(torch.int32),
            max_radii=torch.maximum(stats.max_radii,
                                    torch.stack(radii).amax(dim=0)),
        )
        aux = {"loss": torch.stack(losses).mean(),
               "num_rendered": num_rendered}
        return state, stats, aux

    return train_step
