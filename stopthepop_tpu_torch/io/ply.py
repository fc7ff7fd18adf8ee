"""PLY model IO: the native multithreaded reader and writer.

Port of ``stopthepop_tpu/io/ply.py``. The 3DGS ecosystem stores Gaussian
models as binary-little-endian PLY with an all-float32 vertex element:
x y z nx ny nz f_dc_0..2 f_rest_0..(3M-4) opacity scale_0..2 rot_0..3.
``read_ply`` and ``write_ply`` go through the port's native library,
``native/ply_io.cpp`` (header parse, then ``pread`` on several threads
straight into an [N, P] float32 array), which
``kernels/build.py::build_host`` compiles with the host compiler into
``build/torch_native/`` at first use; a failed build raises, there is no
fallback. The files are byte for byte those of the JAX package's writer.
``_read_ply_numpy`` is the plain version the tests and ``chip_smoke.py``
hold the reader against.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Dict

import numpy as np

from ..kernels import build
from ..models.gaussians import GaussianModel, from_numpy_params

# ply_io.cpp: a header it cannot parse / a format or property type it does
# not take.
_ERR_HEADER, _ERR_FORMAT = -2, -3
_FLOATP = ctypes.POINTER(ctypes.c_float)
_LONGP = ctypes.POINTER(ctypes.c_long)


@functools.lru_cache(maxsize=None)
def _native() -> ctypes.CDLL:
    """The PLY reader and writer, built at first use."""
    lib = build.load_host("ply_io")
    lib.ply_read_header.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_long, _LONGP,
        ctypes.POINTER(ctypes.c_int), _LONGP,
    ]
    lib.ply_read_data.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_long, ctypes.c_int, _FLOATP,
        ctypes.c_int,
    ]
    lib.ply_write.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_long, ctypes.c_int, _FLOATP,
    ]
    for fn in (lib.ply_read_header, lib.ply_read_data, lib.ply_write):
        fn.restype = ctypes.c_int
    return lib


def read_ply(path: str, n_threads: int = 8) -> Dict[str, np.ndarray]:
    """Read an all-float32 binary-LE PLY into {property: [N] float32},
    ``n_threads`` threads reading rows in parallel.

    Raises ValueError for a file that is no such PLY and IOError for one
    that cannot be read."""
    lib = _native()
    p = os.fsencode(path)
    names_buf = ctypes.create_string_buffer(1 << 16)
    n_verts, n_props, offset = ctypes.c_long(), ctypes.c_int(), ctypes.c_long()
    rc = lib.ply_read_header(p, names_buf, len(names_buf), ctypes.byref(n_verts),
                             ctypes.byref(n_props), ctypes.byref(offset))
    if rc in (_ERR_HEADER, _ERR_FORMAT):
        raise ValueError(
            f"{path}: not a binary little-endian PLY with one all-float32 "
            f"vertex element (rc={rc})")
    if rc == 0:
        data = np.empty((n_verts.value, n_props.value), np.float32)
        rc = lib.ply_read_data(p, offset.value, n_verts.value, n_props.value,
                               data.ctypes.data_as(_FLOATP), n_threads)
    if rc != 0:
        raise IOError(f"{path}: PLY read failed (rc={rc})")
    names = names_buf.value.decode().split("\n")
    return {name: data[:, i] for i, name in enumerate(names)}


def write_ply(path: str, props: Dict[str, np.ndarray]):
    """Write {property: [N] float32} as binary-LE PLY (column order kept)."""
    names = list(props.keys())
    data = np.ascontiguousarray(
        np.stack([np.asarray(props[n], np.float32) for n in names], axis=1)
    )
    rc = _native().ply_write(os.fsencode(path), "\n".join(names).encode(),
                             data.shape[0], data.shape[1],
                             data.ctypes.data_as(_FLOATP))
    if rc != 0:
        raise IOError(f"{path}: PLY write failed (rc={rc})")


def load_gaussian_model(path: str, device=None, n_threads: int = 8) -> GaussianModel:
    """Load a 3DGS-format PLY into a GaussianModel on ``device``, reading it
    with ``n_threads`` threads."""
    p = read_ply(path, n_threads=n_threads)
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


def _read_ply_numpy(path: str) -> Dict[str, np.ndarray]:
    """Plain version of ``read_ply`` (numpy, one thread)."""
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
