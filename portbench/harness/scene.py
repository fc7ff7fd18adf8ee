"""The inputs of a run, made from its seed: the scene, cameras, targets.

The scene is the bench scene's distributions (a uniform cloud in a cube of
half-width ``extent``, log-scales uniform in [log 0.01, log 0.1] minus
``scale_log_shift``, quaternions (1, 0, 0, 0) plus 0.1 N(0, 1), opacity
logits uniform in [-1, 2], SH coefficients 0.3 N(0, 1)) at the
configuration's Gaussian count, drawn on the device with a
``torch.Generator`` in one call per parameter. Cameras orbit the origin
looking inward (the render CLI's orbit), in the torch-3DGS transposed
matrix convention; host-side draws (start angle, view order, heights) come
from ``numpy.random.default_rng(seed)``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def make_scene(cfg: dict, gen: torch.Generator, device) -> dict:
    """The scene's raw parameters, float32 on ``device``."""
    n, m = cfg["gaussians"], (cfg["sh_degree"] + 1) ** 2
    ext = cfg["extent"]

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=device) * std

    rotations = normal((n, 4), 0.1)
    rotations[:, 0] += 1.0
    sh = normal((n, m, 3), 0.3)
    return {
        "means3d": uniform((n, 3), -ext, ext),
        "scales_log": uniform((n, 3), math.log(0.01), math.log(0.1))
        - cfg["scale_log_shift"],
        "rotations": rotations,
        "opacity_logit": uniform((n,), -1.0, 2.0),
        "sh_dc": sh[:, :1].contiguous(),
        "sh_rest": sh[:, 1:].contiguous(),
    }


def make_targets(cfg: dict, count: int, gen: torch.Generator, device):
    """``count`` seeded target images [count, 3, H, W] in [0, 1)."""
    return torch.rand((count, 3, cfg["height"], cfg["width"]), generator=gen,
                      device=device)


class Camera(NamedTuple):
    viewmatrix: np.ndarray   # [4, 4] float32, transposed world-to-view
    projmatrix: np.ndarray   # [4, 4] float32, transposed world-to-clip
    inverse_vp: np.ndarray   # [4, 4] float32
    campos: np.ndarray       # [3] float32
    tanfovx: float
    tanfovy: float
    width: int
    height: int


def orbit_camera(theta: float, cfg: dict, radius: float, height: float,
                 znear: float = 0.01, zfar: float = 100.0) -> Camera:
    """Camera at angle ``theta`` (radians) on a circle of ``radius`` at
    ``height``, looking at the origin, with the configuration's horizontal
    field of view and image size."""
    width, h_px = cfg["width"], cfg["height"]
    pos = np.array([radius * math.sin(theta), height, radius * math.cos(theta)])
    z = pos / np.linalg.norm(pos)           # OpenGL camera looks down -z
    x = np.cross([0.0, 1.0, 0.0], z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, y, z, pos
    c2w[:3, 1:3] *= -1.0                    # to the 3DGS (COLMAP) axes
    w2c = np.linalg.inv(c2w)
    tanfovx = math.tan(math.radians(cfg["fov_x_deg"]) / 2.0)
    tanfovy = tanfovx * h_px / width
    proj = np.zeros((4, 4))
    proj[0, 0], proj[1, 1] = 1.0 / tanfovx, 1.0 / tanfovy
    proj[2, 2] = zfar / (zfar - znear)
    proj[2, 3] = -(zfar * znear) / (zfar - znear)
    proj[3, 2] = 1.0
    full = proj @ w2c
    return Camera(w2c.T.astype(np.float32), full.T.astype(np.float32),
                  np.linalg.inv(full).T.astype(np.float32),
                  pos.astype(np.float32), tanfovx, tanfovy, width, h_px)


def reference_camera(cam: Camera, device):
    from reference.render import Camera as RefCamera

    def t(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    return RefCamera(t(cam.viewmatrix), t(cam.projmatrix), t(cam.inverse_vp),
                     t(cam.campos), cam.tanfovx, cam.tanfovy)


def program_camera(cam: Camera):
    """The camera as the program's ``io.cameras.DatasetCamera``."""
    from stopthepop_tpu_torch.io.cameras import DatasetCamera

    return DatasetCamera(cam.viewmatrix, cam.projmatrix, cam.inverse_vp,
                         cam.campos, cam.tanfovx, cam.tanfovy, cam.width,
                         cam.height, None)
