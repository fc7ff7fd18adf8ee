"""COLMAP dataset loading (MipNeRF-360-style captures).

Port of ``stopthepop_tpu/io/colmap.py`` (numpy and ``struct`` only, copied):
parse a COLMAP sparse reconstruction (``cameras.bin`` / ``images.bin`` /
``points3D.bin``, plus the ``.txt`` variants) into ``DatasetCamera`` lists
and an initial point cloud, matching the standard 3DGS
``readColmapSceneInfo`` behavior. The binary writers (and
``rotmat2qvec``, which the JAX module lacks) build captures for tests and
``chip_smoke.py`` (``utils/synthetic.py::write_colmap_capture``).

COLMAP's camera frame IS the 3DGS convention (x right, y down, z forward),
so unlike the Blender loader no axis flip is needed: the world-to-view
matrix comes straight from the per-image quaternion/translation.
"""

from __future__ import annotations

import math
import os
import struct
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from .cameras import DatasetCamera, _projection, focal2fov

# COLMAP camera model ids -> (name, num_params). Focal/principal layout per
# https-colmap docs; only the pinhole-like leading params matter for 3DGS.
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


class ColmapCamera(NamedTuple):
    camera_id: int
    model: str
    width: int
    height: int
    params: np.ndarray  # [num_params] f64


class ColmapImage(NamedTuple):
    image_id: int
    qvec: np.ndarray    # [4] (w, x, y, z)
    tvec: np.ndarray    # [3]
    camera_id: int
    name: str


class ColmapPoints(NamedTuple):
    xyz: np.ndarray     # [N, 3] f32
    rgb: np.ndarray     # [N, 3] f32 in [0, 1]
    error: np.ndarray   # [N] f32


def qvec2rotmat(q) -> np.ndarray:
    """Quaternion (w, x, y, z) -> 3x3 rotation matrix."""
    w, x, y, z = (float(v) for v in q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def rotmat2qvec(R) -> np.ndarray:
    """3x3 rotation matrix -> quaternion (w, x, y, z) with w >= 0 (COLMAP's
    read_write_model.py: the eigenvector of the largest eigenvalue of its
    symmetric 4x4 form); the inverse of ``qvec2rotmat``."""
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = np.asarray(
        R, np.float64).flat
    K = np.array([
        [Rxx - Ryy - Rzz, 0, 0, 0],
        [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
        [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
        [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz],
    ]) / 3.0
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    return -qvec if qvec[0] < 0 else qvec


# ---------------------------------------------------------------------------
# Binary readers (format: COLMAP src/base/reconstruction.cc write_binary)
# ---------------------------------------------------------------------------


def _read(f, fmt):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(size))


def read_cameras_binary(path: str) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, width, height = _read(f, "<iiQQ")
            name, num_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{num_params}d"))
            cams[cam_id] = ColmapCamera(cam_id, name, int(width), int(height), params)
    return cams


def read_images_binary(path: str) -> List[ColmapImage]:
    images = []
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            image_id = _read(f, "<i")[0]
            qvec = np.array(_read(f, "<4d"))
            tvec = np.array(_read(f, "<3d"))
            camera_id = _read(f, "<i")[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00" or c == b"":
                    break
                name += c
            (num_points2d,) = _read(f, "<Q")
            f.seek(24 * num_points2d, 1)  # skip (x f64, y f64, id i64) tracks
            images.append(
                ColmapImage(image_id, qvec, tvec, camera_id, name.decode("utf-8"))
            )
    return images


def read_points3d_binary(path: str) -> ColmapPoints:
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        xyz = np.empty((n, 3), np.float64)
        rgb = np.empty((n, 3), np.uint8)
        err = np.empty((n,), np.float64)
        for i in range(n):
            data = _read(f, "<Q3d3Bd")
            xyz[i] = data[1:4]
            rgb[i] = data[4:7]
            err[i] = data[7]
            (track_len,) = _read(f, "<Q")
            f.seek(8 * track_len, 1)
    return ColmapPoints(
        xyz.astype(np.float32),
        (rgb.astype(np.float32) / 255.0),
        err.astype(np.float32),
    )


# ---------------------------------------------------------------------------
# Text readers (cameras.txt / images.txt / points3D.txt)
# ---------------------------------------------------------------------------


def _text_lines(path):
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                yield line


def read_cameras_text(path: str) -> Dict[int, ColmapCamera]:
    cams = {}
    for line in _text_lines(path):
        parts = line.split()
        cam_id = int(parts[0])
        model = parts[1]
        width, height = int(parts[2]), int(parts[3])
        params = np.array([float(p) for p in parts[4:]])
        cams[cam_id] = ColmapCamera(cam_id, model, width, height, params)
    return cams


def read_images_text(path: str) -> List[ColmapImage]:
    images = []
    lines = list(_text_lines(path))
    # images.txt alternates: image line, then points2D line.
    for line in lines[0::2]:
        parts = line.split()
        images.append(
            ColmapImage(
                int(parts[0]),
                np.array([float(v) for v in parts[1:5]]),
                np.array([float(v) for v in parts[5:8]]),
                int(parts[8]),
                parts[9],
            )
        )
    return images


def read_points3d_text(path: str) -> ColmapPoints:
    xyz, rgb, err = [], [], []
    for line in _text_lines(path):
        parts = line.split()
        xyz.append([float(v) for v in parts[1:4]])
        rgb.append([float(v) for v in parts[4:7]])
        err.append(float(parts[7]))
    return ColmapPoints(
        np.array(xyz, np.float32),
        np.array(rgb, np.float32) / 255.0,
        np.array(err, np.float32),
    )


# ---------------------------------------------------------------------------
# Binary writers (for tests / synthetic datasets; same byte layout)
# ---------------------------------------------------------------------------


def write_cameras_binary(path: str, cams: Dict[int, ColmapCamera]):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cam in cams.values():
            model_id = CAMERA_MODEL_IDS[cam.model]
            f.write(struct.pack("<iiQQ", cam.camera_id, model_id,
                                cam.width, cam.height))
            f.write(struct.pack(f"<{len(cam.params)}d", *cam.params))


def write_images_binary(path: str, images: List[ColmapImage]):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images:
            f.write(struct.pack("<i", im.image_id))
            f.write(struct.pack("<4d", *im.qvec))
            f.write(struct.pack("<3d", *im.tvec))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            f.write(struct.pack("<Q", 0))


def write_points3d_binary(path: str, points: ColmapPoints):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(points.xyz)))
        for i in range(len(points.xyz)):
            f.write(struct.pack("<Q", i))
            f.write(struct.pack("<3d", *points.xyz[i].astype(np.float64)))
            f.write(struct.pack("<3B", *(points.rgb[i] * 255.0).astype(np.uint8)))
            f.write(struct.pack("<d", float(points.error[i])))
            f.write(struct.pack("<Q", 0))


# ---------------------------------------------------------------------------
# Scene assembly (the 3DGS readColmapSceneInfo equivalent)
# ---------------------------------------------------------------------------


def _focals(cam: ColmapCamera) -> Tuple[float, float]:
    if cam.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL",
                     "SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE"):
        return float(cam.params[0]), float(cam.params[0])
    # PINHOLE / OPENCV-style: fx, fy lead the params.
    return float(cam.params[0]), float(cam.params[1])


def camera_from_colmap(
    image: ColmapImage,
    cam: ColmapCamera,
    images_dir: Optional[str] = None,
    downscale: int = 1,
    znear: float = 0.01,
    zfar: float = 100.0,
) -> DatasetCamera:
    """COLMAP (image, camera) -> DatasetCamera in the rasterizer convention."""
    R = qvec2rotmat(image.qvec)
    t = np.asarray(image.tvec, np.float64)
    w2c = np.eye(4)
    w2c[:3, :3] = R
    w2c[:3, 3] = t
    campos = (-R.T @ t).astype(np.float32)

    fx, fy = _focals(cam)
    width = cam.width // downscale
    height = cam.height // downscale
    fovx = focal2fov(fx, cam.width)
    fovy = focal2fov(fy, cam.height)
    tanfovx = math.tan(fovx / 2.0)
    tanfovy = math.tan(fovy / 2.0)
    proj = _projection(znear, zfar, tanfovx, tanfovy)
    full = proj @ w2c

    image_path = None
    if images_dir is not None:
        image_path = os.path.join(images_dir, image.name)
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


def load_colmap(
    scene_dir: str,
    images_subdir: Optional[str] = None,
    downscale: int = 1,
) -> Tuple[List[DatasetCamera], ColmapPoints]:
    """Load a COLMAP scene directory (``sparse/0`` layout like MipNeRF-360).

    ``images_subdir`` defaults to ``images`` (or ``images_{downscale}`` when
    it exists, matching the MipNeRF-360 release layout).
    Returns (cameras sorted by image name, initial point cloud).
    """
    sparse = os.path.join(scene_dir, "sparse", "0")
    if not os.path.isdir(sparse):
        sparse = os.path.join(scene_dir, "sparse")
    if not os.path.isdir(sparse):
        raise FileNotFoundError(f"no COLMAP sparse model under {scene_dir}")

    def pick(name):
        b = os.path.join(sparse, name + ".bin")
        t = os.path.join(sparse, name + ".txt")
        return (b, "bin") if os.path.exists(b) else (t, "txt")

    cam_path, cam_kind = pick("cameras")
    img_path, img_kind = pick("images")
    pts_path, pts_kind = pick("points3D")
    cams = (read_cameras_binary if cam_kind == "bin" else read_cameras_text)(cam_path)
    images = (read_images_binary if img_kind == "bin" else read_images_text)(img_path)
    points = (read_points3d_binary if pts_kind == "bin" else read_points3d_text)(pts_path)

    if images_subdir is None:
        images_subdir = "images"
        if downscale > 1 and os.path.isdir(
            os.path.join(scene_dir, f"images_{downscale}")
        ):
            images_subdir = f"images_{downscale}"
    images_dir = os.path.join(scene_dir, images_subdir)

    images = sorted(images, key=lambda im: im.name)
    dataset = [
        camera_from_colmap(im, cams[im.camera_id], images_dir, downscale)
        for im in images
    ]
    return dataset, points
