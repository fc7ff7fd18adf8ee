"""Procedural structured ground-truth scenes for end-to-end training.

A copy of ``stopthepop_tpu/utils/synthetic.py`` (numpy) that returns the
port's model. The repository ships no captured datasets (lego, garden), so
the trainer's full loop — densification chasing high-frequency detail,
pruning, opacity resets — runs against a procedural ground truth: surfaces
(floor, cube, sphere) covered with flat anisotropic splats carrying
checkered / striped colours, rendered to a NeRF-synthetic-format dataset
(``write_nerf_synthetic``) or a COLMAP capture (``write_colmap_capture``).

The scene stays inside extent ~1.3, so orbit cameras at radius ~4 frame it
like the Blender scenes the loader targets. The same seed gives the same
arrays as the JAX package's copy.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np

from ..models.gaussians import GaussianModel, from_numpy_params


def _quat_from_normal(n: np.ndarray) -> np.ndarray:
    """Quaternion (r, x, y, z) rotating local +z onto each normal. [P, 4]."""
    z = np.array([0.0, 0.0, 1.0])
    c = n @ z  # cos(angle)
    axis = np.cross(np.broadcast_to(z, n.shape), n)
    s = np.linalg.norm(axis, axis=-1)
    # Degenerate (parallel / antiparallel) rows: identity or 180deg about x.
    safe = s > 1e-8
    axis = np.where(safe[:, None], axis / np.maximum(s, 1e-12)[:, None],
                    np.array([1.0, 0.0, 0.0]))
    half = np.arccos(np.clip(c, -1.0, 1.0)) / 2.0
    q = np.concatenate(
        [np.cos(half)[:, None], np.sin(half)[:, None] * axis], axis=-1
    )
    return q.astype(np.float32)


def _checker(u: np.ndarray, v: np.ndarray, freq: float) -> np.ndarray:
    return ((np.floor(u * freq) + np.floor(v * freq)) % 2.0).astype(np.float32)


def _surface_splats(rng, pts, normals, u, v, base_rgb, accent_rgb,
                    freq: float, spacing: float):
    """Common splat attributes for points sampled on one surface."""
    P = pts.shape[0]
    check = _checker(u, v, freq)[:, None]
    stripes = (0.5 + 0.5 * np.sin(u * freq * 7.0))[:, None]
    rgb = (base_rgb[None, :] * (0.45 + 0.55 * check)
           + accent_rgb[None, :] * 0.35 * stripes * (1.0 - check))
    rgb = np.clip(rgb + rng.normal(0.0, 0.02, (P, 3)), 0.02, 0.98)
    # Flat anisotropic splats: tangent extent ~ sample spacing, thin along n.
    tangent = spacing * (0.9 + 0.4 * rng.random((P, 2)))
    scales = np.concatenate(
        [tangent, 0.12 * tangent.mean(axis=1, keepdims=True)], axis=-1
    )
    return rgb.astype(np.float32), np.log(scales).astype(np.float32), \
        _quat_from_normal(normals)


def structured_scene(n: int = 40_000, seed: int = 0, device=None):
    """Ground-truth scene: floor + textured cube + sphere.

    Returns (GaussianModel [sh degree 0 payload in the DC band] on
    ``device``, extent).
    """
    rng = np.random.default_rng(seed)
    n_floor = int(n * 0.4)
    n_cube = (int(n * 0.35) // 6) * 6  # exact 6-way face split
    n_sph = n - n_floor - n_cube
    parts = []

    # Floor: y = -0.6 plane, +-1.25 extent.
    u = rng.uniform(-1.25, 1.25, n_floor)
    v = rng.uniform(-1.25, 1.25, n_floor)
    pts = np.stack([u, np.full(n_floor, -0.6), v], axis=-1)
    nrm = np.tile(np.array([0.0, 1.0, 0.0]), (n_floor, 1))
    spacing = 2.5 / np.sqrt(n_floor / 1.0)
    parts.append((pts, nrm, (u + 1.25) / 2.5, (v + 1.25) / 2.5,
                  np.array([0.55, 0.52, 0.48]), np.array([0.15, 0.3, 0.5]),
                  8.0, spacing))

    # Cube: half-size 0.45 centered at (-0.35, -0.15, 0.1).
    c0 = np.array([-0.35, -0.15, 0.1])
    h = 0.45
    per_face = n_cube // 6
    for axis in range(3):
        for sgn in (-1.0, 1.0):
            m = per_face
            uu = rng.uniform(-h, h, m)
            vv = rng.uniform(-h, h, m)
            p = np.zeros((m, 3))
            p[:, axis] = sgn * h
            p[:, (axis + 1) % 3] = uu
            p[:, (axis + 2) % 3] = vv
            nl = np.zeros((m, 3))
            nl[:, axis] = sgn
            face_hue = np.roll(np.array([0.75, 0.25, 0.2]), axis) \
                * (1.0 if sgn > 0 else 0.7)
            spacing = 2 * h / np.sqrt(m / 1.0)
            parts.append((p + c0, nl, (uu + h) / (2 * h), (vv + h) / (2 * h),
                          face_hue, np.array([0.9, 0.85, 0.2]), 6.0, spacing))

    # Sphere: radius 0.35 at (0.55, -0.25, 0.35).
    s0 = np.array([0.55, -0.25, 0.35])
    r = 0.35
    dirs = rng.normal(size=(n_sph, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    pts = s0 + r * dirs
    uu = 0.5 + np.arctan2(dirs[:, 2], dirs[:, 0]) / (2 * np.pi)
    vv = 0.5 + np.arcsin(np.clip(dirs[:, 1], -1, 1)) / np.pi
    spacing = r * 3.6 / np.sqrt(n_sph)
    parts.append((pts, dirs, uu, vv, np.array([0.2, 0.55, 0.3]),
                  np.array([0.85, 0.3, 0.4]), 10.0, spacing))

    means, rgbs, logs, quats = [], [], [], []
    for pts, nrm, u, v, base, accent, freq, spacing in parts:
        rgb, slog, q = _surface_splats(rng, pts, nrm, u, v, base, accent,
                                       freq, spacing)
        means.append(pts.astype(np.float32))
        rgbs.append(rgb)
        logs.append(slog)
        quats.append(q)
    means = np.concatenate(means)
    rgb = np.concatenate(rgbs)
    P = means.shape[0]

    sh_dc = (rgb - 0.5) / 0.28209479177387814
    model = from_numpy_params(
        {
            "means3d": means,
            "scales_log": np.concatenate(logs),
            "rotations": np.concatenate(quats),
            "opacity_logit": np.full((P,), 4.0, np.float32),  # ~0.982: opaque
            "sh_dc": sh_dc[:, None, :],
            "sh_rest": np.zeros((P, 0, 3), np.float32),
        },
        device,
    )
    return model, 1.3


def write_nerf_synthetic(root: str, model: GaussianModel, *, views: int,
                         size: int, device=None,
                         fov: float = math.radians(50.0)) -> None:
    """Render ``model`` from ``views`` orbit cameras at ``size`` x ``size``
    into ``root`` as a NeRF-synthetic training split (``r_<i>.png`` and
    ``transforms_train.json``), the layout ``train/cli.py`` reads."""
    from ..config import ExtendedSettings
    from ..io.cameras import orbit_camera
    from ..io.images import write_png
    from ..render.cli import render_frames

    os.makedirs(root, exist_ok=True)
    cams = [orbit_camera(2 * math.pi * i / views, fov, size, size)
            for i in range(views)]
    outs = render_frames(model, cams, ExtendedSettings(), device)
    frames = []
    for i, (cam, out) in enumerate(zip(cams, outs)):
        img = out.color.clamp(0, 1).cpu().numpy().transpose(1, 2, 0)
        write_png(os.path.join(root, f"r_{i}.png"),
                  (img * 255 + 0.5).astype(np.uint8))
        c2w = np.linalg.inv(cam.viewmatrix.T.astype(np.float64))
        c2w[:3, 1:3] *= -1.0  # back to the Blender (OpenGL) axes
        frames.append({"file_path": f"r_{i}",
                       "transform_matrix": c2w.tolist()})
    meta = {"camera_angle_x": fov, "w": size, "h": size, "frames": frames}
    with open(os.path.join(root, "transforms_train.json"), "w") as f:
        json.dump(meta, f)


def write_colmap_capture(root: str, model: GaussianModel, *, views: int,
                         width: int, height: int, points: int, seed: int = 0,
                         device=None, fov: float = math.radians(50.0)) -> None:
    """Render ``model`` from ``views`` orbit cameras at ``width`` x
    ``height`` into ``root`` as a COLMAP capture in the MipNeRF-360 layout
    (``images/frame_<i>.png`` and ``sparse/0/{cameras,images,points3D}.bin``
    with one PINHOLE camera), the layout ``train/cli.py`` and
    ``render/cli.py`` read. ``points3D`` holds ``points`` of the model's
    means, drawn with ``seed``, coloured by their SH DC term."""
    from ..config import ExtendedSettings
    from ..io import colmap
    from ..io.cameras import fov2focal, orbit_camera
    from ..io.images import write_png
    from ..render.cli import render_frames

    sparse = os.path.join(root, "sparse", "0")
    images_dir = os.path.join(root, "images")
    os.makedirs(sparse, exist_ok=True)
    os.makedirs(images_dir, exist_ok=True)
    focal = fov2focal(fov, width)
    cam = colmap.ColmapCamera(1, "PINHOLE", width, height,
                              np.array([focal, focal, width / 2, height / 2]))
    images = []
    for i in range(views):
        view = orbit_camera(2 * math.pi * i / views, fov, width, height)
        out = render_frames(model, [view], ExtendedSettings(), device)[0]
        img = out.color.clamp(0, 1).cpu().numpy().transpose(1, 2, 0)
        name = f"frame_{i:03d}.png"
        write_png(os.path.join(images_dir, name),
                  (img * 255 + 0.5).astype(np.uint8))
        w2c = view.viewmatrix.T.astype(np.float64)
        images.append(colmap.ColmapImage(
            i + 1, colmap.rotmat2qvec(w2c[:3, :3]), w2c[:3, 3], 1, name))
    rng = np.random.default_rng(seed)
    pick = np.sort(rng.choice(model.num_gaussians, points, replace=False))
    dc = model.sh_dc.detach()[:, 0].cpu().numpy()[pick]
    colmap.write_cameras_binary(os.path.join(sparse, "cameras.bin"), {1: cam})
    colmap.write_images_binary(os.path.join(sparse, "images.bin"), images)
    colmap.write_points3d_binary(
        os.path.join(sparse, "points3D.bin"), colmap.ColmapPoints(
            xyz=model.means3d.detach().cpu().numpy()[pick],
            rgb=np.clip(0.5 + 0.28209479177387814 * dc, 0.0, 1.0).astype(
                np.float32),
            error=np.zeros(points, np.float32)))
