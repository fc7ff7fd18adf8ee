"""PLY model IO (numpy).

Port of the numpy path of ``stopthepop_tpu/io/ply.py``. The 3DGS ecosystem
stores Gaussian models as binary-little-endian PLY with an all-float32 vertex
element: x y z nx ny nz f_dc_0..2 f_rest_0..(3M-4) opacity scale_0..2
rot_0..3. The JAX package's native multithreaded reader is not ported; this
reads and writes files that it reads and writes.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..models.gaussians import GaussianModel, from_numpy_params


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Read an all-float32 binary-LE PLY into {property: [N] float32}."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        names = []
        n_verts = 0
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unterminated PLY header")
            parts = line.split()
            if parts[0] == b"format" and parts[1] != b"binary_little_endian":
                raise ValueError(f"{path}: unsupported PLY format {parts[1]}")
            if parts[0] == b"element" and parts[1] == b"vertex":
                n_verts = int(parts[2])
            elif parts[0] == b"property":
                if parts[1] not in (b"float", b"float32"):
                    raise ValueError(f"{path}: unsupported property type {parts[1]}")
                names.append(parts[2].decode())
            elif parts[0] == b"end_header":
                break
        data = np.fromfile(f, dtype="<f4", count=n_verts * len(names))
    data = data.reshape(n_verts, len(names))
    return {name: data[:, i] for i, name in enumerate(names)}


def write_ply(path: str, props: Dict[str, np.ndarray]):
    """Write {property: [N] float32} as binary-LE PLY (column order kept)."""
    names = list(props.keys())
    data = np.ascontiguousarray(
        np.stack([np.asarray(props[n], np.float32) for n in names], axis=1)
    )
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {data.shape[0]}\n".encode())
        for n in names:
            f.write(f"property float {n}\n".encode())
        f.write(b"end_header\n")
        data.astype("<f4").tofile(f)


def load_gaussian_model(path: str, device=None) -> GaussianModel:
    """Load a 3DGS-format PLY into a GaussianModel on ``device``."""
    p = read_ply(path)
    n = p["x"].shape[0]
    rest_names = sorted(
        (k for k in p if k.startswith("f_rest_")),
        key=lambda k: int(k.split("_")[-1]),
    )
    if rest_names:
        # 3DGS layout: f_rest is channel-major [3, M-1] flattened.
        rest = np.stack([p[k] for k in rest_names], axis=1)  # [N, 3*(M-1)]
        sh_rest = rest.reshape(n, 3, len(rest_names) // 3).transpose(0, 2, 1)
    else:
        sh_rest = np.zeros((n, 0, 3), np.float32)
    return from_numpy_params(
        {
            "means3d": np.stack([p["x"], p["y"], p["z"]], axis=1),
            "scales_log": np.stack([p[f"scale_{c}"] for c in range(3)], axis=1),
            "rotations": np.stack([p[f"rot_{c}"] for c in range(4)], axis=1),
            "opacity_logit": p["opacity"],
            "sh_dc": np.stack([p[f"f_dc_{c}"] for c in range(3)], axis=1)[:, None, :],
            "sh_rest": sh_rest,
        },
        device,
    )


def save_gaussian_model(path: str, model: GaussianModel):
    """Save a GaussianModel in the standard 3DGS PLY layout."""
    n = model.num_gaussians
    d = {k: v.detach().cpu().numpy() for k, v in model.named_parameters()}
    means = d["means3d"]
    props = {
        "x": means[:, 0], "y": means[:, 1], "z": means[:, 2],
        "nx": np.zeros(n, np.float32),
        "ny": np.zeros(n, np.float32),
        "nz": np.zeros(n, np.float32),
    }
    for c in range(3):
        props[f"f_dc_{c}"] = d["sh_dc"][:, 0, c]
    rest_cm = d["sh_rest"].transpose(0, 2, 1).reshape(n, -1)  # channel-major
    for i in range(rest_cm.shape[1]):
        props[f"f_rest_{i}"] = rest_cm[:, i]
    props["opacity"] = d["opacity_logit"]
    for c in range(3):
        props[f"scale_{c}"] = d["scales_log"][:, c]
    for c in range(4):
        props[f"rot_{c}"] = d["rotations"][:, c]
    write_ply(path, props)
