"""The per-Gaussian preprocess as one CUDA kernel: K8, forward only.

K8 (``csrc/preprocess_fwd.cu``) replaces no Pallas kernel: the JAX package
leaves ``render/preprocess.py`` to XLA, whose fusion the port's eager
PyTorch does not have. One thread a Gaussian computes every field of
``PreprocessOutput`` in one launch, with the operations of the plain
version (``render/preprocess.py`` and the ``ops/`` functions it calls) in
their order; its source notes say what is bitwise and what bounds it.

``render/preprocess.py::preprocess`` launches it where ``takes_kernel``
says so: CUDA inputs, no gradient wanted, no precomputed covariance. The
plain version is the path everywhere else (the CPU, training's autograd,
``cov3d_precomp``) and what the kernel is held against on the card.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..constants import FOV_CLAMP
from . import build

KERNEL = "preprocess_fwd"
SOURCE = "stopthepop_tpu_torch/csrc/preprocess_fwd.cu"
# No Pallas kernel: the JAX package's jnp preprocess, which XLA fuses.
REPLACES = "stopthepop_tpu/render/preprocess.py:76"
# PreprocessOutput's fields in its order, with the dtype and the row width
# ([P] where None) that K8 writes.
FIELDS = (
    ("valid", torch.bool, None), ("p_view", torch.float32, 3),
    ("mean2d", torch.float32, 2), ("depth", torch.float32, None),
    ("conic_opacity", torch.float32, 4), ("rgb", torch.float32, 3),
    ("clamped", torch.bool, 3), ("radius", torch.float32, None),
    ("radii", torch.int32, None), ("rect_dims", torch.float32, 2),
    ("rect_min", torch.int32, 2), ("rect_max", torch.int32, 2),
    ("tiles_touched", torch.int32, None), ("cov3d_inv9", torch.float32, 9),
    ("opacity_power_threshold", torch.float32, None),
)
MAX_SH_DEGREE = 3


def takes_kernel(device, inputs, cov3d_precomp) -> bool:
    """Whether preprocess runs K8: the inputs lie on a CUDA device, no
    gradient is wanted (grad mode off, or no tensor of ``inputs`` requires
    grad; a Parameter under ``inference_mode`` wants none) and no
    covariance is precomputed (``torch.linalg.inv`` of the plain version
    is not repeated bit for bit)."""
    if torch.device(device).type != "cuda" or cov3d_precomp is not None:
        return False
    return not (torch.is_grad_enabled()
                and any(t is not None and t.requires_grad for t in inputs))


def bind(lib):
    """K8's C entry point in a loaded library, typed."""
    fn = lib.stp_preprocess_fwd
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 3
                   + [ctypes.c_float] * 5 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bind():
    return bind(build.load(KERNEL))


def occupancy() -> dict:
    """What K8 reaches on the current device: resident blocks per SM,
    registers and local (spill) bytes a thread, static shared bytes a
    block."""
    out = (ctypes.c_int * 4)()
    err = build.load(KERNEL).stp_preprocess_fwd_occupancy(out)
    if err != 0:
        raise RuntimeError(f"{KERNEL} occupancy query failed: cudaError_t {err}")
    return {"blocks_per_sm": out[0], "registers": out[1],
            "spill_bytes": out[2], "static_smem_bytes": out[3]}


def _checked(name, t, shape, dev):
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, means3d on {dev}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be torch.float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    return t.contiguous()


def preprocess_fwd(means3d, opacities, *, scales, rotations, shs,
                   colors_precomp, scale_modifier, viewmatrix, projmatrix,
                   campos, tanfovx, tanfovy, image_width, image_height,
                   sh_degree, distance_order, rect_bounding,
                   tight_opacity_bounding, proper_ewa_scaling, tile_x,
                   tile_y):
    """PreprocessOutput's 15 fields, in its order, from one launch of K8
    (counted in ``preprocess_fwd.launches``). Inputs are float32 CUDA
    tensors: ``means3d`` [P, 3], ``opacities`` [P], ``scales`` [P, 3],
    ``rotations`` [P, 4], and ``colors_precomp`` [P, 3] (``rgb`` then is
    its copy and ``clamped`` all false) or, where it is None, ``shs``
    [P, M, 3] with M >= (sh_degree + 1)^2; the camera's ``viewmatrix`` and
    ``projmatrix`` [4, 4] and ``campos`` [3] stay on the device."""
    dev = means3d.device
    if dev.type != "cuda":
        raise ValueError(f"no preprocess kernel for device {dev}")
    P = means3d.shape[0]
    means3d = _checked("means3d", means3d, (P, 3), dev)
    opacities = _checked("opacities", opacities.reshape(P), (P,), dev)
    scales = _checked("scales", scales, (P, 3), dev)
    rotations = _checked("rotations", rotations, (P, 4), dev)
    viewmatrix = _checked("viewmatrix", viewmatrix, (4, 4), dev)
    projmatrix = _checked("projmatrix", projmatrix, (4, 4), dev)
    campos = _checked("campos", campos.reshape(3), (3,), dev)
    if colors_precomp is not None:
        # As in the plain version, precomputed colours win over SH.
        colors_precomp = _checked("colors_precomp", colors_precomp, (P, 3), dev)
        shs = None
    elif shs is not None:
        if not 0 <= sh_degree <= MAX_SH_DEGREE:
            raise ValueError(f"sh_degree must lie in [0, {MAX_SH_DEGREE}], "
                             f"got {sh_degree}")
        if shs.dim() != 3 or shs.shape[1] < (sh_degree + 1) ** 2:
            raise ValueError(
                f"shs must be [P, M, 3] with M >= {(sh_degree + 1) ** 2}, "
                f"got {tuple(shs.shape)}")
        shs = _checked("shs", shs, (P, shs.shape[1], 3), dev)
    else:
        raise ValueError("preprocess needs shs or colors_precomp")
    out = [torch.empty((P,) if w is None else (P, w), dtype=dtype, device=dev)
           for _, dtype, w in FIELDS]
    ptrs = (ctypes.c_void_p * len(out))(*(t.data_ptr() for t in out))
    err = _bind()(
        means3d.data_ptr(), opacities.data_ptr(), scales.data_ptr(),
        rotations.data_ptr(), 0 if shs is None else shs.data_ptr(),
        0 if colors_precomp is None else colors_precomp.data_ptr(),
        viewmatrix.data_ptr(), projmatrix.data_ptr(), campos.data_ptr(),
        P, sh_degree, 0 if shs is None else shs.shape[1],
        # Python numbers, rounded to float32 once as PyTorch rounds them.
        float(scale_modifier), image_width / (2.0 * tanfovx),
        image_height / (2.0 * tanfovy), FOV_CLAMP * tanfovx,
        FOV_CLAMP * tanfovy, image_width, image_height, tile_x, tile_y,
        int(distance_order), int(rect_bounding),
        int(tight_opacity_bounding), int(proper_ewa_scaling), ptrs,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{KERNEL} launch failed: cudaError_t {err}")
    preprocess_fwd.launches += 1
    return out


preprocess_fwd.launches = 0
