"""Dataset and orbit cameras (numpy), and their torch per-frame arrays.

Port of ``stopthepop_tpu/io/cameras.py`` (numpy only, copied): matrices in
the torch-3DGS transposed convention the rasterizer expects. The Blender
``transform_matrix`` is camera-to-world in OpenGL convention (camera looks
down -z, y up); flip the y/z axes to the COLMAP-style convention, invert to
world-to-view, and compose with the z-in-[0,1] perspective projection.
"""

from __future__ import annotations

import json
import math
import os
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..utils.device import resolve_device


class DatasetCamera(NamedTuple):
    viewmatrix: np.ndarray          # [4, 4] transposed world-to-view
    projmatrix: np.ndarray          # [4, 4] transposed world-to-clip
    inv_viewprojmatrix: np.ndarray  # [4, 4]
    campos: np.ndarray              # [3]
    tanfovx: float
    tanfovy: float
    width: int
    height: int
    image_path: Optional[str]       # dataset frame file (if any)


class CameraArrays(NamedTuple):
    """The per-camera half of GaussianRasterizationSettings, as tensors."""

    viewmatrix: torch.Tensor          # [4, 4]
    projmatrix: torch.Tensor          # [4, 4]
    inv_viewprojmatrix: torch.Tensor  # [4, 4]
    campos: torch.Tensor              # [3]


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2.0 * math.tan(fov / 2.0))


def focal2fov(focal: float, pixels: float) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))


def _projection(znear, zfar, tanfovx, tanfovy) -> np.ndarray:
    """z-in-[0,1] perspective (math convention, pre-transpose)."""
    p = np.zeros((4, 4), dtype=np.float32)
    p[0, 0] = 1.0 / tanfovx
    p[1, 1] = 1.0 / tanfovy
    p[2, 2] = zfar / (zfar - znear)
    p[2, 3] = -(zfar * znear) / (zfar - znear)
    p[3, 2] = 1.0
    return p


def camera_from_c2w(
    c2w_opengl: np.ndarray,
    fovx: float,
    width: int,
    height: int,
    znear: float = 0.01,
    zfar: float = 100.0,
    image_path: Optional[str] = None,
) -> DatasetCamera:
    """Build a DatasetCamera from an OpenGL camera-to-world matrix."""
    c2w = np.array(c2w_opengl, dtype=np.float64)
    c2w[:3, 1:3] *= -1.0  # OpenGL -> COLMAP-style axes (3DGS convention)
    w2c = np.linalg.inv(c2w)
    campos = c2w[:3, 3].astype(np.float32)

    tanfovx = math.tan(fovx / 2.0)
    fovy = focal2fov(fov2focal(fovx, width), height)
    tanfovy = math.tan(fovy / 2.0)
    proj = _projection(znear, zfar, tanfovx, tanfovy)
    full = proj @ w2c
    return DatasetCamera(
        viewmatrix=w2c.T.astype(np.float32),
        projmatrix=full.T.astype(np.float32),
        inv_viewprojmatrix=np.linalg.inv(full).T.astype(np.float32),
        campos=campos,
        tanfovx=tanfovx,
        tanfovy=tanfovy,
        width=width,
        height=height,
        image_path=image_path,
    )


def load_nerf_synthetic(
    transforms_path: str,
    width: int = 800,
    height: int = 800,
) -> List[DatasetCamera]:
    """Load a Blender transforms_{train,test}.json into DatasetCameras."""
    with open(transforms_path) as f:
        meta = json.load(f)
    fovx = float(meta["camera_angle_x"])
    width = int(meta.get("w", width))
    height = int(meta.get("h", height))
    root = os.path.dirname(os.path.abspath(transforms_path))
    cams = []
    for frame in meta["frames"]:
        img = frame.get("file_path")
        if img is not None:
            img = os.path.join(root, img)
            for ext in ("", ".png", ".jpg"):
                if os.path.exists(img + ext):
                    img = img + ext
                    break
        cams.append(
            camera_from_c2w(
                np.asarray(frame["transform_matrix"]),
                fovx, width, height, image_path=img,
            )
        )
    return cams


def to_camera_arrays(cam: DatasetCamera, device=None) -> CameraArrays:
    """DatasetCamera -> CameraArrays of contiguous float32 tensors on
    ``device`` (a camera's matrices are often transposed numpy views)."""
    dev = resolve_device(device)

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float32), device=dev)

    return CameraArrays(
        viewmatrix=t(cam.viewmatrix),
        projmatrix=t(cam.projmatrix),
        inv_viewprojmatrix=t(cam.inv_viewprojmatrix),
        campos=t(cam.campos),
    )


def orbit_camera(
    theta: float,
    fovx: float,
    width: int,
    height: int,
    radius: float = 4.0,
    cam_height: float = 0.5,
    target=(0.0, 0.0, 0.0),
) -> DatasetCamera:
    """Camera orbiting ``target`` at ``radius``, looking inward (OpenGL
    camera-to-world built from a look-at frame, then converted like the
    Blender loader)."""
    target = np.asarray(target, np.float64)
    pos = target + np.array(
        [radius * math.sin(theta), cam_height, radius * math.cos(theta)]
    )
    forward = target - pos
    forward = forward / np.linalg.norm(forward)
    z = -forward  # OpenGL camera looks down -z
    up = np.array([0.0, 1.0, 0.0])
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, y, z, pos
    return camera_from_c2w(c2w, fovx, width, height)
