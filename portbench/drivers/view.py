"""Traffic of kind ``view``: one viewer, a closed loop along an orbit.

The viewer asks for a frame through the program's render entry
(``render/cli.py::render_frames``, under ``inference_mode``, one frame a
call) and waits for it on the device before it asks for the next. The
cameras walk the orbit of the mix (``radius``, ``cam_height``) by
``deg_per_frame`` a frame from a start angle drawn from the seed. Set-up
makes the scene on the device and renders ``warmup_frames`` frames of the
path before its start. The window renders frames until ``seconds`` have
passed; ``check_frames`` of them, drawn from the seed, are compared with
the reference's frames of their cameras once the window has closed and the
program's state is freed. A traced run then profiles ``trace_frames``
renders of the compared cameras, so that the reference's event counts are
those of the traced frames, and times the preprocess and the pairs from
outside with CUDA events.

``control`` reads the control's numbers (the reference in bfloat16 against
the reference) on the frames a run of the seed compares; ``FAULTS`` are
the faults planted in the program that the check has to catch.
"""

from __future__ import annotations

import contextlib
import math
import time

import torch

from harness import check, common, scene, trace


def _cameras(ctx):
    mix = ctx.mix
    start = float(ctx.rng().uniform(0.0, 360.0))

    def cam(i):
        theta = math.radians(start + i * mix["deg_per_frame"])
        return scene.orbit_camera(theta, ctx.cfg, mix["radius"], mix["cam_height"])

    return cam


def _stages(ctx, model, cams):
    """Device ms of the preprocess and of the pairs at ``cams``, each the
    program's own call as the rasterizer makes it (CUDA events)."""
    from stopthepop_tpu_torch.io.cameras import to_camera_arrays
    from stopthepop_tpu_torch.render.pipeline import _binned_pairs
    from stopthepop_tpu_torch.render.preprocess import preprocess

    cfg, dev = ctx.cfg, ctx.device
    tx, ty = cfg["tile"]
    order = common.settings(cfg).sort_settings.sort_order
    out = {"preprocess_ms": 0.0, "pairs_ms": 0.0}
    with torch.inference_mode():
        for c in cams:
            a = to_camera_arrays(scene.program_camera(c), dev)

            def pre():
                return preprocess(
                    model.means3d, model.opacities(), scales=model.scales(),
                    rotations=model.rotations_normalized(), shs=model.shs(),
                    viewmatrix=a.viewmatrix, projmatrix=a.projmatrix,
                    campos=a.campos, tanfovx=c.tanfovx, tanfovy=c.tanfovy,
                    image_width=c.width, image_height=c.height,
                    sh_degree=cfg["sh_degree"],
                    rect_bounding=cfg["rect_bounding"],
                    tight_opacity_bounding=cfg["tight_opacity_bounding"],
                    tile_x=tx, tile_y=ty)

            out["preprocess_ms"] += trace.cuda_ms(pre, 5) / len(cams)
            prep = pre()
            out["pairs_ms"] += trace.cuda_ms(lambda: _binned_pairs(
                prep, tx, ty, image_width=c.width, image_height=c.height,
                sort_order=order,
                tile_based_culling=False, campos=a.campos,
                inverse_vp=a.inv_viewprojmatrix),
                5) / len(cams)
    return out


def run(ctx) -> dict:
    from stopthepop_tpu_torch.render.cli import render_frames

    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    ctx.mark("program")
    gen = scene.generator(ctx.seed, dev)
    model = common.model(scene.make_scene(cfg, gen, dev))
    common.sync(dev)
    ctx.mark("scene")
    ext = common.settings(cfg)
    tile = common.tile_shape(cfg)
    cam = _cameras(ctx)

    def frame(c):
        return render_frames(model, [scene.program_camera(c)], ext, dev,
                             tile_shape=tile)[0]

    for i in range(mix["warmup_frames"]):
        last = time.perf_counter()
        frame(cam(i - mix["warmup_frames"]))
        common.sync(dev)
        warm_s = time.perf_counter() - last
        ctx.mark(f"frame {i + 1}")
    setup_s = common.since(ctx.t_start)

    # Frames drawn for the check: among those the window will surely hold.
    expect = max(1, int(0.5 * ctx.seconds / max(warm_s, 1e-3)))
    drawn = sorted(int(i) for i in ctx.rng().choice(
        expect, size=min(mix["check_frames"], expect), replace=False))
    common.reset_peak(dev)
    lat, pairs, kept = [], [], {}
    t0 = time.perf_counter()
    while True:
        i = len(lat)
        a = time.perf_counter()
        out = frame(cam(i))
        common.sync(dev)
        b = time.perf_counter()
        lat.append(b - a)
        pairs.append(out.num_rendered)
        if i in drawn:
            kept[i] = out.color
        if b - t0 >= ctx.seconds:
            break
    window_s = b - t0
    peak = common.peak_bytes(dev)
    frames = len(lat)
    if any(i not in kept for i in drawn):   # a frame the window did not reach
        kept.setdefault(frames - 1, out.color)
    del out
    run_info = {"config": cfg, "mix": mix, "frames": frames,
                "frame_ms": 1e3 * window_s / frames,
                "pairs_per_frame": sum(pairs) / frames}
    if ctx.trace:
        checked = [cam(i) for i in sorted(kept)]
        run_info["stage_ms"] = _stages(ctx, model, checked)
        run_info["trace"] = trace.profile(
            lambda i: frame(checked[i % len(checked)]), mix["trace_frames"],
            "frame")
    del model
    common.free(dev)

    # The reference, from the inputs made again from the seed.
    from reference.render import render

    ref_scene = scene.make_scene(cfg, scene.generator(ctx.seed, dev), dev)
    counts = {} if ctx.trace else None
    worst = 0.0
    for i in sorted(kept):
        want = render(ref_scene, scene.reference_camera(cam(i), dev), cfg, counts)
        worst = max(worst, check.frame_mse(kept[i], want))
    if counts is not None:
        run_info["counts"] = {k: v / counts["frames"] for k, v in counts.items()}
    return {
        "e2e": {"frame_ms": 1e3 * window_s / frames,
                "frame_ms_p95": 1e3 * common.p95(lat),
                "peak_mem_gib": peak / 2**30, "setup_s": setup_s},
        "numbers": {"frame_mse": worst},
        "attempted": frames,
        "failed": sum(1 for c in kept.values()
                      if not bool(torch.isfinite(c).all())),
        "peak_bytes": peak, "run": run_info,
    }


def control(ctx) -> dict:
    """The control's numbers at the frames a run of ``ctx``'s seed compares
    first: the reference in bfloat16 against the reference."""
    from reference.render import render

    cfg, dev = ctx.cfg, ctx.device
    scn = scene.make_scene(cfg, scene.generator(ctx.seed, dev), dev)
    cam = _cameras(ctx)
    worst = 0.0
    for i in range(ctx.mix["check_frames"]):
        c = scene.reference_camera(cam(i), dev)
        worst = max(worst, check.frame_mse(render(scn, c, cfg, lowp=True),
                                           render(scn, c, cfg)))
    return {"frame_mse": worst}


@contextlib.contextmanager
def altered_frame():
    """Every frame the render entry produces has its centre 16x16 tile left
    black: an answer altered where it is produced."""
    from stopthepop_tpu_torch.render import cli

    real = cli.rasterize_gaussians

    def broken(*args, **kw):
        out = real(*args, **kw)
        color = out.color.clone()
        h, w = color.shape[-2:]
        y, x = (h // 2) // 16 * 16, (w // 2) // 16 * 16
        color[:, y:y + 16, x:x + 16] = 0.0
        return out._replace(color=color)

    cli.rasterize_gaussians = broken
    try:
        yield
    finally:
        cli.rasterize_gaussians = real


FAULTS = {"altered_frame": altered_frame}
