"""End-to-end 3DGS training CLI on NeRF-synthetic and COLMAP captures (torch).

Usage:
    python -m stopthepop_tpu_torch.train.cli --data /path/to/nerf_synthetic/lego \\
        --iters 7000 --capacity 262144 --out lego.ply
    # a COLMAP capture (MipNeRF-360 layout: sparse/0, images[_N]):
    python -m stopthepop_tpu_torch.train.cli --data /path/to/360/bicycle \\
        --downscale 4 --iters 7000 --out bicycle.ply

Port of ``stopthepop_tpu/train/cli.py``: dataset loading, the
densify / prune / opacity-reset schedule, per-group learning rates, periodic
PSNR evaluation, checkpointing and PLY export, through the port's
HIERARCHICAL pipeline by default, as the JAX CLI (kernels K5 and K6 on the
GPU, queues ``SortQueueSizes`` (64, 8, 4); ``--device cpu`` runs their plain
versions), or with ``--sort-mode GLOBAL`` the global-sort pipeline (kernels
K1 and K2) or with ``--sort-mode PPX_KBUFFER`` the k-buffer pipeline
(kernels K3 and K4, window ``SortQueueSizes.per_pixel`` = 4). Rasterization
uses rect, tight-opacity and tile-based culling, as the JAX CLI does.
``--tile`` sets the binning tile of training and evaluation: ``auto`` (the
default, as in the JAX CLI) is 32x16 in GLOBAL and 16x16 otherwise; GLOBAL
takes any WxH, the other modes 16x16 and 32x16; ``--tile 16x16`` is
reference parity. The JAX CLI's TPU flags (pair
capacity, segment cap, bf16 carriers, rank key, interpret mode) have no
counterpart: the pair count is dynamic here. A ``--data`` directory with a ``sparse/`` subdirectory is a COLMAP
capture: every 8th view (sorted by name) is held out for evaluation, the
model starts from its ``points3D`` cloud and the scene extent is 1.1 times
the largest distance of a camera centre from their centroid, as in the JAX
CLI. ``--sort-mode PPX_FULL`` is refused when the
arguments are parsed: the exact-sort mode renders forward only, as the
reference's (render it with render/cli.py).
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from ..config import ExtendedSettings, GaussianRasterizationSettings, SortMode
from ..io.cameras import load_nerf_synthetic, to_camera_arrays
from ..io.colmap import load_colmap
from ..io.images import read_png_batch, to_float_rgb
from ..io.ply import save_gaussian_model
from ..models.gaussians import from_points
from ..utils.device import resolve_device
from .checkpoint import save_checkpoint
from .density import DensifyConfig, densify_and_prune, reset_opacity
from .loss import psnr
from .trainer import (
    TrainState,
    init_densify_stats,
    init_train_state,
    make_3dgs_optimizer,
    make_train_step,
    render_model,
)

class TrainResult(NamedTuple):
    state: TrainState
    eval_psnr: Dict[int, float]   # iteration -> mean eval PSNR (dB)
    num_gaussians: List[int]      # after each densification round


def _downscale(img: np.ndarray, factor: int) -> np.ndarray:
    """Integer-factor area-average downscale of a [H, W, C] float image."""
    if factor <= 1:
        return img
    h, w, c = img.shape
    h2, w2 = h // factor, w // factor
    return img[: h2 * factor, : w2 * factor].reshape(
        h2, factor, w2, factor, c
    ).mean(axis=(1, 3))


def _load_targets(cams, downscale: int, bg: np.ndarray):
    imgs = read_png_batch([c.image_path for c in cams])
    targets, out_cams = [], []
    for cam, raw in zip(cams, imgs):
        img = _downscale(to_float_rgb(raw, bg), downscale)
        h, w = img.shape[:2]
        if (h, w) != (cam.height, cam.width):
            cam = cam._replace(width=w, height=h)
        targets.append(img.transpose(2, 0, 1))  # [3, H, W]
        out_cams.append(cam)
    return out_cams, np.stack(targets)


def load_dataset(data_dir: str, split: str, downscale: int, bg: np.ndarray,
                 limit: int = 0):
    """Load (cameras, target images [N,3,H,W]) for a NeRF-synthetic split."""
    path = os.path.join(data_dir, f"transforms_{split}.json")
    cams = load_nerf_synthetic(path)
    if limit:
        cams = cams[:limit]
    return _load_targets(cams, downscale, bg)


def is_colmap_scene(data_dir: str) -> bool:
    return os.path.isdir(os.path.join(data_dir, "sparse"))


def load_colmap_dataset(data_dir: str, split: str, downscale: int,
                        bg: np.ndarray, limit: int = 0, llffhold: int = 8):
    """Load a COLMAP capture (MipNeRF-360 layout) with the standard 3DGS
    every-``llffhold``-th test split. Returns (cams, targets, points,
    scene_extent) — extent per getNerfppNorm: 1.1x the max camera distance
    from the camera centroid."""
    cams, points = load_colmap(data_dir, downscale=downscale)
    centers = np.stack([c.campos for c in cams])
    extent = 1.1 * float(
        np.max(np.linalg.norm(centers - centers.mean(0), axis=1))
    )
    test = [c for i, c in enumerate(cams) if llffhold and i % llffhold == 0]
    train = [c for i, c in enumerate(cams)
             if not llffhold or i % llffhold != 0]
    sel = test if split == "test" else train
    if limit:
        sel = sel[:limit]
    # MipNeRF-360 ships pre-scaled images_N dirs (load_colmap picked one);
    # otherwise area-downscale the full-res frames here.
    prescaled = downscale > 1 and os.path.isdir(
        os.path.join(data_dir, f"images_{downscale}")
    )
    out_cams, targets = _load_targets(sel, 1 if prescaled else downscale, bg)
    return out_cams, targets, points, extent


def make_static_settings(cam, bg, sh_degree: int, sort_mode: SortMode,
                         device) -> GaussianRasterizationSettings:
    settings = ExtendedSettings()
    settings.sort_settings.sort_mode = sort_mode
    settings.culling_settings.rect_bounding = True
    settings.culling_settings.tight_opacity_bounding = True
    settings.culling_settings.tile_based_culling = True
    return GaussianRasterizationSettings(
        image_height=cam.height, image_width=cam.width,
        tanfovx=cam.tanfovx, tanfovy=cam.tanfovy,
        bg=torch.as_tensor(bg, dtype=torch.float32, device=device),
        scale_modifier=1.0, viewmatrix=None, projmatrix=None,
        inv_viewprojmatrix=None, sh_degree=sh_degree, campos=None,
        prefiltered=False, settings=settings,
    )


def init_model(rng: np.random.Generator, n_points: int, extent: float,
               sh_degree: int, device):
    """Random-in-box init, as the upstream trainer does for Blender scenes."""
    pts = rng.uniform(-extent, extent, (n_points, 3)).astype(np.float32)
    cols = rng.uniform(0.0, 1.0, (n_points, 3)).astype(np.float32)
    return from_points(pts, cols, sh_degree=sh_degree, device=device)


def binning_tile(tile: str, sort_mode: SortMode):
    """``--tile``'s binning tile: ``auto`` is 32x16 in GLOBAL and 16x16
    otherwise (the JAX CLI's rule); "WxH" is that tile; 16x16 is None."""
    if tile == "auto":
        return (32, 16) if sort_mode == SortMode.GLOBAL else None
    try:
        tw, th = (int(v) for v in tile.lower().split("x"))
    except ValueError:
        raise ValueError(f"--tile must be auto or WxH, got {tile!r}") from None
    return None if (tw, th) == (16, 16) else (tw, th)


def main(argv=None) -> TrainResult:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data", required=True,
                    help="NeRF-synthetic scene dir (has transforms_*.json) "
                         "or COLMAP capture (has sparse/)")
    ap.add_argument("--iters", type=int, default=7000)
    ap.add_argument("--capacity", type=int, default=1 << 17,
                    help="most Gaussians densification may grow to")
    ap.add_argument("--init-points", type=int, default=10_000)
    ap.add_argument("--sh-degree", type=int, default=3)
    ap.add_argument("--downscale", type=int, default=1)
    ap.add_argument("--white-bg", action="store_true")
    ap.add_argument("--sort-mode", default="HIER",
                    choices=[m.name for m in SortMode],
                    help="HIER (default, as the JAX CLI), GLOBAL or "
                         "PPX_KBUFFER (PPX_FULL renders forward only)")
    ap.add_argument("--scene-extent", type=float, default=1.3,
                    help="NeRF-synthetic cameras orbit radius ~4, object ~1.3")
    ap.add_argument("--sh-ramp-every", type=int, default=1000,
                    help="activate one more SH band every N steps (the "
                    "upstream oneupSHdegree schedule); 0 = all bands "
                    "active from step 0")
    ap.add_argument("--densify-from", type=int, default=500)
    ap.add_argument("--densify-until", type=int, default=15_000)
    ap.add_argument("--densify-every", type=int, default=100)
    ap.add_argument("--opacity-reset-every", type=int, default=3000)
    ap.add_argument("--eval-every", type=int, default=1000)
    ap.add_argument("--eval-frames", type=int, default=8)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=5000)
    ap.add_argument("--out", default=None, help="output PLY path")
    ap.add_argument("--train-frames", type=int, default=0,
                    help="limit training frames (0 = all)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--tile", default="auto",
                    help="binning tile WxH (auto = 32x16 for GLOBAL, "
                         "16x16 otherwise)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    sort_mode = SortMode[args.sort_mode]
    if sort_mode == SortMode.PPX_FULL:
        raise ValueError(
            "--sort-mode PPX_FULL cannot train: the exact per-pixel sort "
            "renders forward only, as the reference's PER_PIXEL_FULL "
            "(backward.cu:733-736 throws). Train in HIER, GLOBAL or "
            "PPX_KBUFFER and render PPX_FULL with render/cli.py.")

    bg = np.ones(3, np.float32) if args.white_bg else np.zeros(3, np.float32)
    print(f"loading {args.data} ...", flush=True)
    rng = np.random.default_rng(args.seed)
    init_points = None
    if is_colmap_scene(args.data):
        cams, targets, points, extent = load_colmap_dataset(
            args.data, "train", args.downscale, bg, limit=args.train_frames)
        eval_cams, eval_targets, _, _ = load_colmap_dataset(
            args.data, "test", args.downscale, bg, limit=args.eval_frames)
        args.scene_extent = extent
        init_points = points
    else:
        cams, targets = load_dataset(args.data, "train", args.downscale, bg,
                                     limit=args.train_frames)
        try:
            eval_cams, eval_targets = load_dataset(
                args.data, "test", args.downscale, bg, limit=args.eval_frames)
        except FileNotFoundError:
            eval_cams, eval_targets = (cams[: args.eval_frames],
                                       targets[: args.eval_frames])
    h, w = cams[0].height, cams[0].width
    print(f"{len(cams)} train / {len(eval_cams)} eval frames @ {w}x{h}, "
          f"{device}", flush=True)

    if init_points is not None:
        model = from_points(init_points.xyz, init_points.rgb,
                            sh_degree=args.sh_degree, device=device)
        print(f"init from {init_points.xyz.shape[0]} COLMAP points, "
              f"scene extent {args.scene_extent:.2f}", flush=True)
    else:
        model = init_model(rng, args.init_points, args.scene_extent,
                           args.sh_degree, device)
    static = make_static_settings(cams[0], bg, args.sh_degree, sort_mode,
                                  device)
    render_kwargs = {"tile_shape": binning_tile(args.tile, sort_mode)}
    if render_kwargs["tile_shape"] is not None:
        print(f"perf defaults: {render_kwargs}", flush=True)
    optimizer = make_3dgs_optimizer(model, spatial_lr_scale=args.scene_extent,
                                    position_lr_max_steps=args.iters)
    state = init_train_state(model, optimizer)
    stats = init_densify_stats(model.num_gaussians, device)
    step_fn = make_train_step(static=static, sh_ramp_every=args.sh_ramp_every,
                              render_kwargs=render_kwargs)
    cam_arrays = [to_camera_arrays(c, device) for c in cams]
    targets = torch.as_tensor(targets, dtype=torch.float32, device=device)
    eval_arrays = [to_camera_arrays(c, device) for c in eval_cams]
    eval_targets = torch.as_tensor(eval_targets, dtype=torch.float32,
                                   device=device)
    cfg = DensifyConfig()
    split_gen = torch.Generator(device=device)
    eval_psnr: Dict[int, float] = {}
    sizes: List[int] = []

    def evaluate():
        with torch.inference_mode():
            vals = [float(psnr(render_model(state.model, ca, static=static,
                                            **render_kwargs)[0], tgt))
                    for ca, tgt in zip(eval_arrays, eval_targets)]
        return sum(vals) / len(vals)

    order = rng.permutation(len(cams))
    pos = 0
    t0 = time.time()
    for it in range(1, args.iters + 1):
        if pos == len(order):
            order = rng.permutation(len(cams))
            pos = 0
        idx = int(order[pos])
        pos += 1
        state, stats, aux = step_fn(state, cam_arrays[idx], targets[idx],
                                    stats)

        if (args.densify_from <= it <= args.densify_until
                and it % args.densify_every == 0):
            split_gen.manual_seed(args.seed * 100_003 + it)
            stats, info = densify_and_prune(
                state.model, state.optimizer, stats, split_gen,
                scene_extent=args.scene_extent, capacity=args.capacity,
                cfg=cfg,
            )
            sizes.append(info["num_active"])
            if info["dropped"]:
                print(f"iter {it:6d}  densify: {info['dropped']} requests "
                      f"over --capacity {args.capacity} dropped", flush=True)

        if it % args.opacity_reset_every == 0 and it < args.densify_until:
            reset_opacity(state.model, state.optimizer)

        if it % 100 == 0 or it == 1:
            print(f"iter {it:6d}  loss {float(aux['loss']):.4f}  gaussians "
                  f"{state.model.num_gaussians:7d}  "
                  f"({(time.time() - t0):.1f}s)", flush=True)
        if it % args.eval_every == 0:
            eval_psnr[it] = evaluate()
            print(f"iter {it:6d}  eval PSNR {eval_psnr[it]:.2f} dB",
                  flush=True)
        if args.checkpoint_dir and it % args.checkpoint_every == 0:
            save_checkpoint(args.checkpoint_dir, state, stats, step=it)

    eval_psnr[args.iters] = evaluate()
    print(f"final eval PSNR {eval_psnr[args.iters]:.2f} dB "
          f"({args.iters} iters, {(time.time() - t0):.1f}s)", flush=True)
    if args.out:
        save_gaussian_model(args.out, state.model)
        print(f"saved {args.out}", flush=True)
    if args.checkpoint_dir:
        save_checkpoint(args.checkpoint_dir, state, stats, step=args.iters)
    return TrainResult(state, eval_psnr, sizes)


if __name__ == "__main__":
    main()
