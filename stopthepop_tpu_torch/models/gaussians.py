"""GaussianModel: the 3DGS parameter set as an ``nn.Module``.

Port of ``stopthepop_tpu/models/gaussians.py``: raw (pre-activation)
parameters — means, log-scales, unnormalized quaternions, opacity logits, SH
coefficients — with the standard 3DGS activations. ``from_numpy_params`` and
``to_numpy_params`` carry weights across from and to the JAX package's model
(its ``GaussianModel._asdict()`` with every leaf run through ``np.asarray``).
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
