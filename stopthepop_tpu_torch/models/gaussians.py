"""GaussianModel: the 3DGS parameter set as an ``nn.Module``.

Port of ``stopthepop_tpu/models/gaussians.py``: raw (pre-activation)
parameters — means, log-scales, unnormalized quaternions, opacity logits, SH
coefficients — with the standard 3DGS activations. ``from_numpy_params`` and
``to_numpy_params`` carry weights across from and to the JAX package's model
(its ``GaussianModel._asdict()`` with every leaf run through ``np.asarray``).
``from_points`` is the 3DGS point-cloud initialization, with the JAX
package's Morton-window k-nearest-neighbour scale rule, in numpy.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from ..utils.device import resolve_device

PARAM_NAMES = ("means3d", "scales_log", "rotations", "opacity_logit",
               "sh_dc", "sh_rest")


class GaussianModel(torch.nn.Module):
    """Raw parameters, all [P, ...] float32 ``nn.Parameter``s."""

    def __init__(self, means3d, scales_log, rotations, opacity_logit, sh_dc,
                 sh_rest):
        super().__init__()
        self.means3d = torch.nn.Parameter(means3d)              # [P, 3]
        self.scales_log = torch.nn.Parameter(scales_log)        # [P, 3]
        self.rotations = torch.nn.Parameter(rotations)          # [P, 4] (r, x, y, z)
        self.opacity_logit = torch.nn.Parameter(opacity_logit)  # [P]
        self.sh_dc = torch.nn.Parameter(sh_dc)                  # [P, 1, 3]
        self.sh_rest = torch.nn.Parameter(sh_rest)              # [P, M-1, 3]

    @property
    def num_gaussians(self) -> int:
        return self.means3d.shape[0]

    @property
    def sh_degree(self) -> int:
        return int(round(math.sqrt(1 + self.sh_rest.shape[1]))) - 1

    # -- activations (standard 3DGS) --
    def scales(self):
        return torch.exp(self.scales_log)

    def opacities(self):
        return torch.sigmoid(self.opacity_logit)

    def rotations_normalized(self):
        return self.rotations / torch.linalg.norm(
            self.rotations, dim=-1, keepdim=True
        )

    def shs(self):
        return torch.cat([self.sh_dc, self.sh_rest], dim=1)


def from_numpy_params(d: Dict[str, np.ndarray], device=None) -> GaussianModel:
    """Model from a dict of arrays named like the JAX model's fields
    (the arrays are copied)."""
    dev = resolve_device(device)
    return GaussianModel(*(
        torch.tensor(np.asarray(d[k], np.float32), device=dev)
        for k in PARAM_NAMES
    ))


def to_numpy_params(model: GaussianModel) -> Dict[str, np.ndarray]:
    """The model's raw parameters as float32 numpy arrays (CPU copies)."""
    return {k: getattr(model, k).detach().cpu().numpy() for k in PARAM_NAMES}


def row_block(model: GaussianModel, index: int, count: int) -> GaussianModel:
    """Block ``index`` of ``count`` equal, contiguous row blocks of the
    model (P % count == 0), as new leaf parameters: a Gaussian shard."""
    P = model.num_gaussians
    if P % count:
        raise ValueError(f"{P} Gaussians do not split into {count} shards")
    rows = slice(index * (P // count), (index + 1) * (P // count))
    return GaussianModel(*(getattr(model, k).detach()[rows].clone()
                           for k in PARAM_NAMES))


def init_random(num_gaussians: int, seed: int = 0, extent: float = 1.5,
                sh_degree: int = 3, device=None) -> GaussianModel:
    """Random model with the JAX package's distributions, drawn with numpy.

    The draws differ from ``jax.random``'s for the same seed; carry weights
    across with ``from_numpy_params`` where both packages need one model.
    """
    rng = np.random.default_rng(seed)
    m = (sh_degree + 1) ** 2
    n = num_gaussians
    means = rng.uniform(-extent, extent, (n, 3))
    scales_log = rng.uniform(math.log(0.01), math.log(0.1), (n, 3))
    q = np.zeros((n, 4))
    q[:, 0] = 1.0
    q = q + 0.1 * rng.standard_normal((n, 4))
    opacity_logit = rng.uniform(-1.0, 2.0, (n,))
    sh = 0.3 * rng.standard_normal((n, m, 3), dtype=np.float32)
    return from_numpy_params(
        {
            "means3d": means,
            "scales_log": scales_log,
            "rotations": q,
            "opacity_logit": opacity_logit,
            "sh_dc": sh[:, :1],
            "sh_rest": sh[:, 1:],
        },
        device,
    )


def _morton_codes(points: np.ndarray, bits: int = 10) -> np.ndarray:
    """Interleaved-bit Morton codes of points quantized to a 2^bits grid."""
    lo = points.min(axis=0)
    hi = points.max(axis=0)
    q = ((points - lo) / np.maximum(hi - lo, np.float32(1e-12))
         * np.float32((1 << bits) - 1)).astype(np.int32)
    code = np.zeros(points.shape[0], dtype=np.int32)
    for b in range(bits):
        for axis in range(3):
            code = code | (((q[:, axis] >> b) & 1) << (3 * b + axis))
    return code


def mean_knn_distance(points: np.ndarray, k: int = 3,
                      window: int = 8) -> np.ndarray:
    """Approximate mean distance to the k nearest neighbours per point
    (float32 [P] for float32 [P, 3] points).

    As the JAX package does it: sort the points along a Morton curve and
    search only the +-``window`` neighbours in curve order (the upstream
    trainer's simple_knn stand-in; a few percent off the exact kNN).
    """
    points = np.asarray(points, np.float32)
    P = points.shape[0]
    order = np.argsort(_morton_codes(points), kind="stable")
    sorted_pts = points[order]
    idx = np.arange(P)
    dists = []
    for s in range(1, window + 1):
        for sign in (1, -1):
            shifted = np.roll(sorted_pts, sign * s, axis=0)
            d = np.linalg.norm(sorted_pts - shifted, axis=1)
            wrapped = (idx - sign * s < 0) | (idx - sign * s >= P)
            dists.append(np.where(wrapped, np.inf, d).astype(np.float32))
    dmat = np.stack(dists, axis=1)  # [P, 2 * window]
    knn = np.sort(dmat, axis=1)[:, :k]
    knn = np.where(np.isfinite(knn), knn, np.float32(0.0))
    out = np.zeros((P,), np.float32)
    out[order] = knn.mean(axis=1, dtype=np.float32)
    return out


def from_points(points, colors, sh_degree: int = 3,
                initial_opacity: float = 0.1, knn_scale_init: bool = True,
                device=None) -> GaussianModel:
    """3DGS-style init from a point cloud ([P, 3] points, [P, 3] RGB in
    [0, 1]): isotropic log-scales from the mean 3-NN distance, DC colour
    from RGB through the inverse SH_C0 transform, opacity 0.1."""
    points = np.asarray(points, np.float32)
    colors = np.asarray(colors, np.float32)
    P = points.shape[0]
    m = (sh_degree + 1) ** 2
    if knn_scale_init and P > 4:
        d = np.maximum(mean_knn_distance(points, k=3), np.float32(1e-7))
        scales_log = np.log(d)[:, None] * np.ones((1, 3), np.float32)
    else:
        extent = np.maximum(points.max(axis=0) - points.min(axis=0),
                            np.float32(1e-6))
        avg_spacing = (np.prod(extent) / P) ** (1.0 / 3.0)
        scales_log = np.full((P, 3), np.log(max(avg_spacing, 1e-7)))
    q = np.zeros((P, 4), np.float32)
    q[:, 0] = 1.0
    inv_sigmoid = math.log(initial_opacity / (1 - initial_opacity))
    sh_dc = ((colors - np.float32(0.5)) / np.float32(0.28209479177387814))
    return from_numpy_params(
        {
            "means3d": points,
            "scales_log": scales_log,
            "rotations": q,
            "opacity_logit": np.full((P,), inv_sigmoid),
            "sh_dc": sh_dc[:, None, :],
            "sh_rest": np.zeros((P, m - 1, 3)),
        },
        device,
    )
