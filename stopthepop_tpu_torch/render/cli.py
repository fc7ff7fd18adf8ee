"""Offline rendering CLI: PLY model -> image sequence (+ FPS report).

Port of ``stopthepop_tpu/render/cli.py``: load a trained 3DGS model, render
an orbit (or the cameras of a NeRF-synthetic dataset or, where ``--data``
holds ``sparse/``, of a COLMAP capture, sorted by image name) in the GLOBAL
sort mode
(kernel K1), with ``--sort-mode PPX_KBUFFER`` the k-buffer mode (kernel K3,
window 4), with ``--sort-mode HIER`` the hierarchical mode (kernel K5,
queues tile_4x4 64, tile_2x2 8, per_pixel 4) or with ``--sort-mode PPX_FULL``
the exact per-pixel sort (the API's ``full_mode="auto"`` rule: kernel K7
on the GPU; on the CPU the dense oracle of render/naive.py while
P·W·H <= 2**26), with rect and
tight-opacity culling, and write PNG frames.
Renders run on the GPU under ``torch.inference_mode()``.

Usage:
    python -m stopthepop_tpu_torch.render.cli --ply model.ply --out frames/ \\
        --frames 4 --width 1920 --height 1080
"""

from __future__ import annotations

import argparse
import math
import os
import time
from typing import List, Optional

import numpy as np
import torch

from ..config import ExtendedSettings, GaussianRasterizationSettings, SortMode
from ..io.cameras import (
    CameraArrays,
    DatasetCamera,
    load_nerf_synthetic,
    orbit_camera,
    to_camera_arrays,
)
from ..io.colmap import load_colmap
from ..io.images import write_png
from ..io.ply import load_gaussian_model
from ..models.gaussians import GaussianModel
from ..utils.device import resolve_device
from ..utils.profiling import span
from .rasterize import RenderOutput, rasterize_gaussians


def render_model(
    model: GaussianModel,
    cam: CameraArrays,
    *,
    static: GaussianRasterizationSettings,
    means2d_dummy: Optional[torch.Tensor] = None,
    **kw,
):
    """Render a GaussianModel through the public API (the JAX package's
    ``train/trainer.py::render_model``)."""
    rs = static._replace(
        viewmatrix=cam.viewmatrix,
        projmatrix=cam.projmatrix,
        inv_viewprojmatrix=cam.inv_viewprojmatrix,
        campos=cam.campos,
    )
    with span("params"):
        shs, opacities = model.shs(), model.opacities()
        scales, rotations = model.scales(), model.rotations_normalized()
    return rasterize_gaussians(
        model.means3d, means2d_dummy, shs, None, opacities, scales,
        rotations, None, rs, **kw)


def render_frames(
    model: GaussianModel,
    cams: List[DatasetCamera],
    settings: ExtendedSettings,
    device=None,
    *,
    bg=(0.0, 0.0, 0.0),
    sh_degree: Optional[int] = None,
    render_depth: bool = False,
    tile_shape: Optional[tuple] = None,
) -> List[RenderOutput]:
    """Render ``model`` from every camera; one RenderOutput per frame.

    The model must already lie on ``device`` (default: the GPU). With
    ``render_depth`` each colour is the Depth debug visualization.
    ``tile_shape`` is the binning tile (``rasterize_gaussians``).
    """
    dev = resolve_device(device)
    if model.means3d.device.type != dev.type:
        raise ValueError(
            f"model is on {model.means3d.device}, rendering on {dev}"
        )
    cam0 = cams[0]
    static = GaussianRasterizationSettings(
        image_height=cam0.height, image_width=cam0.width,
        tanfovx=cam0.tanfovx, tanfovy=cam0.tanfovy,
        bg=torch.as_tensor(bg, dtype=torch.float32, device=dev),
        scale_modifier=1.0,
        viewmatrix=None, projmatrix=None, inv_viewprojmatrix=None,
        sh_degree=model.sh_degree if sh_degree is None else sh_degree,
        campos=None, prefiltered=False, settings=settings,
        render_depth=render_depth,
    )
    with torch.inference_mode():
        return [
            render_model(model, to_camera_arrays(c, dev), static=static,
                         full_output=True, tile_shape=tile_shape)
            for c in cams
        ]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ply", required=True)
    ap.add_argument("--out", required=True, help="output directory for PNGs")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--size", type=int, default=800)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--fovx-deg", type=float, default=60.0)
    ap.add_argument("--radius", type=float, default=4.0)
    ap.add_argument("--cam-height", type=float, default=0.5)
    ap.add_argument("--data", default=None,
                    help="render this dataset's test/train cameras instead "
                         "of an orbit (NeRF-synthetic or COLMAP dir)")
    ap.add_argument("--sort-mode", default="GLOBAL",
                    choices=[m.name for m in SortMode],
                    help="GLOBAL, PPX_KBUFFER, HIER (default queues) or "
                         "PPX_FULL (exact per-pixel sort)")
    ap.add_argument("--sh-degree", type=int, default=None,
                    help="override (default: from the PLY)")
    ap.add_argument("--white-bg", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    model = load_gaussian_model(args.ply, device)
    width = args.width or args.size
    height = args.height or args.size
    bg = (1.0, 1.0, 1.0) if args.white_bg else (0.0, 0.0, 0.0)

    if args.data:
        if os.path.isdir(os.path.join(args.data, "sparse")):
            cams, _ = load_colmap(args.data)
        else:
            path = os.path.join(args.data, "transforms_test.json")
            if not os.path.exists(path):
                path = os.path.join(args.data, "transforms_train.json")
            cams = load_nerf_synthetic(path)
        cams = cams[: args.frames]
        width, height = cams[0].width, cams[0].height
    else:
        fovx = math.radians(args.fovx_deg)
        cams = [
            orbit_camera(2 * math.pi * i / args.frames, fovx, width, height,
                         radius=args.radius, cam_height=args.cam_height)
            for i in range(args.frames)
        ]

    settings = ExtendedSettings()
    settings.sort_settings.sort_mode = SortMode[args.sort_mode]
    settings.culling_settings.rect_bounding = True
    settings.culling_settings.tight_opacity_bounding = True

    os.makedirs(args.out, exist_ok=True)
    print(f"{model.num_gaussians} gaussians, {len(cams)} frames @ "
          f"{width}x{height}, {args.sort_mode}, {device}", flush=True)
    render_frames(model, cams[:1], settings, device, bg=bg,
                  sh_degree=args.sh_degree)  # warm-up
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    outs = render_frames(model, cams, settings, device, bg=bg,
                         sh_degree=args.sh_degree)
    frames = [torch.clamp(o.color, 0.0, 1.0).cpu().numpy() for o in outs]
    dt = time.perf_counter() - t0
    for i, img in enumerate(frames):
        u8 = (img.transpose(1, 2, 0) * 255.0 + 0.5).astype(np.uint8)
        write_png(os.path.join(args.out, f"frame_{i:04d}.png"), u8)
    fps = len(cams) / dt
    print(f"rendered {len(cams)} frames in {dt:.2f}s = {fps:.1f} FPS "
          f"({fps * width * height / 1e6:.1f} Mpix/s)", flush=True)


if __name__ == "__main__":
    main()
