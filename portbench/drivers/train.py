"""Traffic of kind ``train``: 3DGS training steps, one camera a step.

Set-up makes the scene, ``views`` orbit cameras (``radius``, heights
``cam_height`` plus a jitter uniform in +-``height_jitter``, both drawn
from the seed) and a seeded target image for each, then builds the
program's training step (``train/trainer.py::make_train_step`` with
``make_3dgs_optimizer`` at the mix's learning rates, the full SH degree, no
densification) and drives it through its first ``check_steps`` steps,
each on another view, before ``warmup_steps`` more. Those first steps are
the ones compared: their losses, the first gradient of every leaf (from
Adam's first moment after one step) and each leaf's change over them. The
window then takes steps, views in an order drawn from the seed, until
``seconds`` have passed. A traced run times the trainer's three stages and
the loss alone with CUDA events and profiles ``trace_steps`` steps on the
compared views.

``control`` reads the control's numbers (the reference in bfloat16 against
the reference) over the steps a run of the seed compares; ``FAULTS`` are
the faults planted in the program that the check has to catch.
"""

from __future__ import annotations

import contextlib
import math
import time

import torch

from harness import check, common, scene, trace


def _views(ctx):
    mix, rng = ctx.mix, ctx.rng()
    n = mix["views"]
    heights = mix["cam_height"] + rng.uniform(-mix["height_jitter"],
                                              mix["height_jitter"], n)
    cams = [scene.orbit_camera(2 * math.pi * j / n, ctx.cfg, mix["radius"],
                               float(heights[j])) for j in range(n)]
    order = [int(j) for _ in range(64) for j in rng.permutation(n)]
    return cams, order


def _norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in tensors.items()}


def _readings(out, start: dict):
    """(losses, {leaf: first gradient's norm}, {leaf: change's norm}) of
    the reference's ``train_steps`` output from the leaves ``start``."""
    losses, grads, final = out
    return losses, _norms(grads), _norms({k: final[k] - start[k] for k in final})


def _numbers(got, want) -> dict:
    """The compared numbers of readings ``got`` against ``want``. Leaves
    whose reference gradient is under a thousandth of the median leaf's
    are left out of the change: they move under Adam by rounding alone."""
    median = check._median(list(want[1].values()))
    moved = [k for k, g in want[1].items() if g >= 1e-3 * median]
    return {"loss_gap": check.loss_gap(got[0], want[0]),
            "grad_gap": check.norm_gap(got[1], want[1]),
            "change_gap": check.norm_gap(got[2], want[2], moved)}


def _stages(ctx, state, static, cams, targets, render_kwargs):
    """Device ms of the trainer's forward, backward and optimizer stages
    (one step on each compared view) and of the loss's forward and
    backward alone (CUDA events)."""
    from stopthepop_tpu_torch.train import trainer
    from stopthepop_tpu_torch.train.loss import rgb_loss

    out = {"forward_ms": 0.0, "backward_ms": 0.0, "optimizer_ms": 0.0}
    for cam, target in zip(cams, targets):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        loss, _, _ = trainer.step_forward(
            state, cam, target, static=static,
            lambda_dssim=ctx.mix["lambda_dssim"], render_kwargs=render_kwargs)
        ev[1].record()
        trainer.step_backward(state, loss)
        ev[2].record()
        state = trainer.step_update(state)
        ev[3].record()
        torch.cuda.synchronize()
        for i, k in enumerate(out):
            out[k] += ev[i].elapsed_time(ev[i + 1]) / len(cams)
    image = targets[0].flip(-1).clone().requires_grad_(True)

    def loss_pass():
        rgb_loss(image, targets[0], ctx.mix["lambda_dssim"]).backward()

    out["loss_ms"] = trace.cuda_ms(loss_pass, 5)
    return state, out


def run(ctx) -> dict:
    from stopthepop_tpu_torch.config import GaussianRasterizationSettings
    from stopthepop_tpu_torch.io.cameras import to_camera_arrays
    from stopthepop_tpu_torch.models.gaussians import PARAM_NAMES
    from stopthepop_tpu_torch.train import trainer

    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    ctx.mark("program")
    gen = scene.generator(ctx.seed, dev)
    model = common.model(scene.make_scene(cfg, gen, dev))
    targets = scene.make_targets(cfg, mix["views"], gen, dev)
    common.sync(dev)
    ctx.mark("scene")
    cams, order = _views(ctx)
    arrays = [to_camera_arrays(scene.program_camera(c), dev) for c in cams]
    lr = mix["lr"]
    optimizer = trainer.make_3dgs_optimizer(
        model, 1.0, position_lr_init=mix["position_lr"]["init"],
        position_lr_final=mix["position_lr"]["final"],
        position_lr_max_steps=mix["position_lr"]["max_steps"],
        feature_lr=lr["sh_dc"], opacity_lr=lr["opacity_logit"],
        scaling_lr=lr["scales_log"], rotation_lr=lr["rotations"])
    if not math.isclose(optimizer.param_groups[-1]["lr"], lr["sh_rest"]):
        raise ValueError("the mix's sh_rest rate is not the trainer's "
                         "feature rate / 20")
    static = GaussianRasterizationSettings(
        image_height=cfg["height"], image_width=cfg["width"],
        tanfovx=cams[0].tanfovx, tanfovy=cams[0].tanfovy,
        bg=torch.zeros(3, device=dev), scale_modifier=1.0, viewmatrix=None,
        projmatrix=None, inv_viewprojmatrix=None, sh_degree=cfg["sh_degree"],
        campos=None, prefiltered=False, settings=common.settings(cfg))
    render_kwargs = {"tile_shape": common.tile_shape(cfg)}
    step = trainer.make_train_step(static=static,
                                   lambda_dssim=mix["lambda_dssim"],
                                   render_kwargs=render_kwargs)
    state = trainer.init_train_state(model, optimizer)
    stats = trainer.init_densify_stats(model.num_gaussians, dev)

    def take(s):
        nonlocal state, stats
        v = order[s]
        state, stats, aux = step(state, arrays[v], targets[v], stats)
        return aux

    beta1 = optimizer.param_groups[0]["betas"][0]
    params = {k: getattr(model, k) for k in PARAM_NAMES}
    losses = []
    ctx.mark("step built")
    for s in range(mix["check_steps"]):
        losses.append(float(take(s)["loss"]))
        ctx.mark(f"step {s + 1}")
        if s == 0:
            # Adam's first moment after one step is (1 - beta1) g; a step
            # that never reached the optimizer left it no moment.
            grad_norms = {k: float(torch.linalg.vector_norm(
                optimizer.state[p].get("exp_avg", torch.zeros(())))) / (1.0 - beta1)
                for k, p in params.items()}
    with torch.no_grad():
        start = scene.make_scene(cfg, scene.generator(ctx.seed, dev), dev)
        change_norms = _norms({k: params[k] - start[k] for k in params})
        del start
    ctx.mark("start norms")
    for s in range(mix["warmup_steps"]):
        take(mix["check_steps"] + s)
    common.sync(dev)
    ctx.mark("warm-up")
    setup_s = common.since(ctx.t_start)

    common.reset_peak(dev)
    first = mix["check_steps"] + mix["warmup_steps"]
    window_losses = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds:
        window_losses.append(take(first + len(window_losses))["loss"])
    common.sync(dev)
    window_s = time.perf_counter() - t0
    peak = common.peak_bytes(dev)
    steps = len(window_losses)
    failed = int((~torch.isfinite(torch.stack(window_losses))).sum())
    checked = [order[s] for s in range(mix["check_steps"])]
    run_info = {"config": cfg, "mix": mix, "steps": steps,
                "step_ms": 1e3 * window_s / steps}
    if ctx.trace:
        state, run_info["stage_ms"] = _stages(
            ctx, state, static, [arrays[v] for v in checked],
            [targets[v] for v in checked], render_kwargs)

        def one(i):
            nonlocal state, stats
            v = checked[i % len(checked)]
            state, stats, _ = step(state, arrays[v], targets[v], stats)

        run_info["trace"] = trace.profile(one, mix["trace_steps"], "step")
    del state, stats, model, optimizer, params, targets, take, step
    common.free(dev)

    # The reference, from the inputs made again from the seed.
    from reference.render import train_steps

    gen = scene.generator(ctx.seed, dev)
    ref_scene = scene.make_scene(cfg, gen, dev)
    targets = scene.make_targets(cfg, mix["views"], gen, dev)
    counts = {} if ctx.trace else None
    ref = train_steps(
        ref_scene, [scene.reference_camera(cams[v], dev) for v in checked],
        [targets[v] for v in checked], cfg, mix, counts=counts)
    if counts is not None:
        run_info["counts"] = {k: v / counts["frames"] for k, v in counts.items()}
    numbers = _numbers((losses, grad_norms, change_norms),
                       _readings(ref, ref_scene))
    return {
        "e2e": {"step_ms": 1e3 * window_s / steps,
                "peak_mem_gib": peak / 2**30, "setup_s": setup_s},
        "numbers": numbers, "attempted": steps, "failed": failed,
        "peak_bytes": peak, "run": run_info,
    }


def control(ctx) -> dict:
    """The control's numbers over the steps a run of ``ctx``'s seed
    compares: the reference in bfloat16 against the reference."""
    from reference.render import train_steps

    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    gen = scene.generator(ctx.seed, dev)
    scn = scene.make_scene(cfg, gen, dev)
    targets = scene.make_targets(cfg, mix["views"], gen, dev)
    cams, order = _views(ctx)
    views = order[:mix["check_steps"]]
    args = (scn, [scene.reference_camera(cams[v], dev) for v in views],
            [targets[v] for v in views], cfg, mix)
    return _numbers(_readings(train_steps(*args, lowp=True), scn),
                    _readings(train_steps(*args), scn))


@contextlib.contextmanager
def half_batch():
    """The loss is taken over the top half of the image's rows only, the
    mean over the rest: half of the batch left out."""
    from stopthepop_tpu_torch.train import trainer

    real = trainer.rgb_loss

    def broken(pred, target, lambda_dssim=0.2):
        h = pred.shape[-2] // 2
        return real(pred[..., :h, :], target[..., :h, :], lambda_dssim)

    trainer.rgb_loss = broken
    try:
        yield
    finally:
        trainer.rgb_loss = real


@contextlib.contextmanager
def frozen_state():
    """The optimizer stage returns the state unchanged but for its count:
    a step that leaves the parameters where they were."""
    from stopthepop_tpu_torch.train import trainer

    real = trainer.step_update

    def broken(state):
        return state._replace(step=state.step + 1)

    trainer.step_update = broken
    try:
        yield
    finally:
        trainer.step_update = real


FAULTS = {"half_batch": half_batch, "frozen_state": frozen_state}
