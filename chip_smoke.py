#!/usr/bin/env python3
"""GPU smoke test of the PyTorch/CUDA port (stopthepop_tpu_torch).

Run from the root of the repository on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero:
  1. build: compile every CUDA kernel of the port with nvcc (in parallel).
  2. kernel: hold kernel K1 (GLOBAL blend, forward) against its plain PyTorch
     version on the card — a 70x45 random scene and the full 1920x1080 frame
     of the 500K-Gaussian bench scene (color / final_T within atol 1e-5,
     n_contrib exactly) — and time both.
  3. main path: save a 500K-Gaussian model as PLY, load it back, render 4
     orbit frames at 1920x1080 through render/cli.py::render_frames (GLOBAL,
     Z_DEPTH, rect + tight-opacity culling) under inference_mode; every frame
     finite and not background, ~1M+ pairs a frame, K1 launched exactly once
     per frame. Then a per-stage breakdown of one frame (CUDA events).
  4. the kernels line: each ported kernel with its launches on the main path,
     its error against the plain version, its time, the plain version's
     time and its bound on this card.
The line before the last is the card's name and power limit from nvidia-smi;
the last line is {"ok": true, "device": {...}}.

Imports nothing of JAX and nothing of the JAX package. Without a CUDA device
it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"
WIDTH, HEIGHT, NUM_GAUSSIANS, FRAMES = 1920, 1080, 500_000, 4
MIN_PAIRS = 900_000  # the bench scene emits ~1.28M pairs a frame at 1080p
ATOL = 1e-5
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and FP32 (non-tensor) op/s.
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
# Operations counted per (pixel, pair) alpha evaluation of K1 (dx, dy and the
# quadratic form) and per blend (w, three colour and one depth update);
# expf, min and compares are not counted, so the bound stays a lower bound.
OPS_PER_EVAL, OPS_PER_BLEND = 11, 9


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, phase, msg):
    if not cond:
        print(json.dumps({"phase": phase, "ok": False, "error": msg}),
              file=sys.stderr, flush=True)
        sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() in ms, from CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def blend_args(prep, pairs):
    return (pairs.gauss_id, pairs.starts, pairs.ends, prep.mean2d.contiguous(),
            prep.conic_opacity.contiguous(), prep.rgb.contiguous(),
            prep.depth.contiguous())


def prepare(scene_or_model, cam, width, height):
    from stopthepop_tpu_torch.render.duplicate import build_pairs
    from stopthepop_tpu_torch.render.pipeline import tile_grid
    from stopthepop_tpu_torch.render.preprocess import preprocess

    m = scene_or_model
    prep = preprocess(
        m["means3d"], m["opacities"], scales=m["scales"],
        rotations=m["rotations"], shs=m["shs"],
        viewmatrix=cam.viewmatrix, projmatrix=cam.projmatrix,
        campos=cam.campos, tanfovx=cam.tanfovx, tanfovy=cam.tanfovy,
        image_width=width, image_height=height, sh_degree=3,
        rect_bounding=True, tight_opacity_bounding=True,
    )
    gx, gy = tile_grid(width, height)
    pairs = build_pairs(prep, grid_x=gx, grid_y=gy)
    return prep, pairs, dict(grid_x=gx, grid_y=gy, width=width, height=height)


def model_arrays(model):
    return {"means3d": model.means3d, "opacities": model.opacities(),
            "scales": model.scales(), "rotations": model.rotations_normalized(),
            "shs": model.shs()}


def compare_kernel(name, args, kw, *, count_evaluations=False):
    """K1 against its plain version on the same inputs; returns stats."""
    from stopthepop_tpu_torch.kernels.global_blend import (
        blend_global_forward,
        blend_global_forward_plain,
    )

    before = blend_global_forward.launches
    got = blend_global_forward(*args, **kw)
    torch.cuda.synchronize()
    check(blend_global_forward.launches == before + 1, "kernel",
          f"{name}: launch counter did not move")
    ref = blend_global_forward_plain(*args, **kw,
                                     count_evaluations=count_evaluations)
    err_color = (got[0] - ref[0]).abs().max().item()
    err_t = (got[1] - ref[1]).abs().max().item()
    n_bad = int((got[2] != ref[2]).sum())
    err_depth = ((got[3] - ref[3]).abs() / ref[3].abs().clamp(min=1.0)).max().item()
    finite = all(bool(torch.isfinite(x).all()) for x in (got[0], got[1], got[3]))
    stats = {"max_abs_err_color": err_color, "max_abs_err_final_t": err_t,
             "n_contrib_mismatches": n_bad, "max_rel_err_depth_acc": err_depth,
             "finite": finite}
    check(finite and err_color <= ATOL and err_t <= ATOL and n_bad == 0
          and err_depth <= ATOL, "kernel", f"{name}: kernel disagrees: {stats}")
    if count_evaluations:
        stats["evaluations"], stats["blends"] = ref[4], ref[5]
    return stats


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from stopthepop_tpu_torch.config import ExtendedSettings
    from stopthepop_tpu_torch.io.cameras import orbit_camera
    from stopthepop_tpu_torch.io.ply import load_gaussian_model, save_gaussian_model
    from stopthepop_tpu_torch.kernels import build, global_blend
    from stopthepop_tpu_torch.models.gaussians import init_random, to_numpy_params
    from stopthepop_tpu_torch.render.cli import render_frames
    from stopthepop_tpu_torch.utils.testing import make_camera, random_scene

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    card = card_line()

    # 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    build.build(build.all_sources())
    build_s = time.perf_counter() - t0
    emit({"phase": "build", "ok": True, "seconds": build_s, "card": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kernels": {
              n: {"seconds": log["seconds"],
                  "ptxas": [ln.strip() for ln in log["ptxas"].splitlines()
                            if "Used" in ln or "spill" in ln]}
              for n, log in build.build_log.items()
          }})

    # 2. kernel against plain version -----------------------------------------
    scene = random_scene(0, 300, device=dev)
    small = {"means3d": scene.means3d, "opacities": scene.opacities,
             "scales": scene.scales, "rotations": scene.rotations,
             "shs": scene.shs}
    prep, pairs, kw = prepare(small, make_camera(70, 45, device=dev), 70, 45)
    small_stats = compare_kernel("70x45", blend_args(prep, pairs), kw)
    emit({"phase": "kernel", "ok": True, "case": "70x45 random scene, 300 Gaussians",
          "pairs": pairs.num_rendered, **small_stats})
    model = init_random(NUM_GAUSSIANS, seed=0, extent=1.5, sh_degree=3, device=dev)
    with torch.no_grad():
        model.scales_log -= 2.3  # trained-scene-like footprints (bench.py:109-111)
    with torch.inference_mode():
        bench_cam = make_camera(WIDTH, HEIGHT, campos=(0.0, 0.0, -4.0), device=dev)
        prep, pairs, kw = prepare(model_arrays(model), bench_cam, WIDTH, HEIGHT)
        bargs = blend_args(prep, pairs)
        full_stats = compare_kernel("1080p", bargs, kw, count_evaluations=True)
        k1_ms = cuda_ms(lambda: global_blend.blend_global_forward(*bargs, **kw), 20)
        plain_ms = cuda_ms(
            lambda: global_blend.blend_global_forward_plain(*bargs, **kw), 2, 1)
    P, N, T = NUM_GAUSSIANS, pairs.num_rendered, kw["grid_x"] * kw["grid_y"]
    bytes_moved = 4 * (N + 2 * T + P * (2 + 4 + 3 + 1) + WIDTH * HEIGHT * 6)
    ops = OPS_PER_EVAL * full_stats["evaluations"] + OPS_PER_BLEND * full_stats["blends"]
    bytes_ms, ops_ms = bytes_moved / PEAK_BYTES_S * 1e3, ops / PEAK_FP32_S * 1e3
    emit({"phase": "kernel", "ok": True,
          "case": "1920x1080, 500K Gaussians, bench camera", "pairs": N,
          **full_stats, "k1_ms": k1_ms, "plain_ms": plain_ms,
          "bytes": bytes_moved, "ops": ops, "bytes_bound_ms": bytes_ms,
          "ops_bound_ms": ops_ms, "card": card})

    # 3. main path --------------------------------------------------------------
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    ply = out_dir / "model_500k.ply"
    t0 = time.perf_counter()
    save_gaussian_model(str(ply), model)
    loaded = load_gaussian_model(str(ply), device=dev)
    io_s = time.perf_counter() - t0
    saved = to_numpy_params(model)
    for k, v in to_numpy_params(loaded).items():
        check((v == saved[k]).all(), "main", f"PLY round trip changed {k}")
    ply.unlink()
    cams = [orbit_camera(2 * math.pi * i / FRAMES, math.radians(60.0), WIDTH, HEIGHT)
            for i in range(FRAMES)]
    settings = ExtendedSettings()
    settings.culling_settings.rect_bounding = True
    settings.culling_settings.tight_opacity_bounding = True
    render_frames(loaded, cams[:1], settings, dev)  # warm-up (allocator, cuBLAS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    global_blend.blend_global_forward.launches = 0
    t0 = time.perf_counter()
    outs = render_frames(loaded, cams, settings, dev)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = global_blend.blend_global_forward.launches
    bg = torch.zeros(3, device=dev)
    del saved
    pairs_per_frame = [o.num_rendered for o in outs]
    for i, o in enumerate(outs):
        check(o.color.shape == (3, HEIGHT, WIDTH), "main", f"frame {i} shape {tuple(o.color.shape)}")
        check(bool(torch.isfinite(o.color).all()), "main", f"frame {i} not finite")
        check(bool((o.color != bg[:, None, None]).any()), "main", f"frame {i} is background")
        check(o.num_rendered >= MIN_PAIRS, "main", f"frame {i}: only {o.num_rendered} pairs")
    check(launches == FRAMES, "main", f"K1 launched {launches} times for {FRAMES} frames")

    # Per-stage device times of frame 0 (CUDA events), after the counted run.
    from stopthepop_tpu_torch.io.cameras import to_camera_arrays
    from stopthepop_tpu_torch.render.duplicate import build_pairs
    from stopthepop_tpu_torch.render.preprocess import preprocess

    cam0 = to_camera_arrays(cams[0], dev)
    with torch.inference_mode():
        arrays = model_arrays(loaded)
        pre_kw = dict(scales=arrays["scales"], rotations=arrays["rotations"],
                      shs=arrays["shs"], viewmatrix=cam0.viewmatrix,
                      projmatrix=cam0.projmatrix, campos=cam0.campos,
                      tanfovx=cams[0].tanfovx, tanfovy=cams[0].tanfovy,
                      image_width=WIDTH, image_height=HEIGHT, sh_degree=3,
                      rect_bounding=True, tight_opacity_bounding=True)
        stage = {}
        stage["preprocess_ms"] = cuda_ms(
            lambda: preprocess(arrays["means3d"], arrays["opacities"], **pre_kw), 10)
        prep0 = preprocess(arrays["means3d"], arrays["opacities"], **pre_kw)
        stage["pairs_ms"] = cuda_ms(
            lambda: build_pairs(prep0, grid_x=kw["grid_x"], grid_y=kw["grid_y"]), 10)
        pairs0 = build_pairs(prep0, grid_x=kw["grid_x"], grid_y=kw["grid_y"])
        args0 = blend_args(prep0, pairs0)
        stage["k1_ms"] = cuda_ms(
            lambda: global_blend.blend_global_forward(*args0, **kw), 20)
    emit({"phase": "main", "ok": True, "frames": FRAMES, "width": WIDTH,
          "height": HEIGHT, "gaussians": NUM_GAUSSIANS,
          "pairs_per_frame": pairs_per_frame, "ms_per_frame": dt * 1e3 / FRAMES,
          "frames_per_s": FRAMES / dt, "k1_launches": launches,
          "frame0_stage_ms": stage, "ply_save_load_s": io_s,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
          "card": card})

    # 4. kernels ------------------------------------------------------------------
    emit({"kernels": [{
        "name": global_blend.KERNEL, "route": "cuda",
        "source": global_blend.SOURCE, "replaces": global_blend.REPLACES,
        "launches": launches,
        "max_abs_err": max(small_stats["max_abs_err_color"],
                           small_stats["max_abs_err_final_t"],
                           full_stats["max_abs_err_color"],
                           full_stats["max_abs_err_final_t"]),
        "ms": k1_ms, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }]})
    print(card)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
