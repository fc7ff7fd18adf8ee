"""Spherical-harmonics color evaluation on torch tensors.

Port of ``stopthepop_tpu/ops/sh.py`` (reference forward_common.h:20-70).
"""

from __future__ import annotations

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
SH_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)


def eval_sh(sh, means3d, campos, degree: int):
    """Evaluate SH colors for every Gaussian.

    Args:
      sh: [P, M, 3] coefficients (M >= (degree+1)^2).
      means3d: [P, 3] Gaussian centers.
      campos: [3] camera position.
      degree: int in [0, 3] — active SH degree.

    Returns (rgb [P, 3] = max(result + 0.5, 0), clamped [P, 3] bool mask of
    where the clamp was active).
    """
    d = means3d - campos
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    x, y, z = d[..., 0:1], d[..., 1:2], d[..., 2:3]

    result = SH_C0 * sh[:, 0]
    if degree > 0:
        result = (
            result - SH_C1 * y * sh[:, 1] + SH_C1 * z * sh[:, 2] - SH_C1 * x * sh[:, 3]
        )
        if degree > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            result = (
                result
                + SH_C2[0] * xy * sh[:, 4]
                + SH_C2[1] * yz * sh[:, 5]
                + SH_C2[2] * (2.0 * zz - xx - yy) * sh[:, 6]
                + SH_C2[3] * xz * sh[:, 7]
                + SH_C2[4] * (xx - yy) * sh[:, 8]
            )
            if degree > 2:
                result = (
                    result
                    + SH_C3[0] * y * (3.0 * xx - yy) * sh[:, 9]
                    + SH_C3[1] * xy * z * sh[:, 10]
                    + SH_C3[2] * y * (4.0 * zz - xx - yy) * sh[:, 11]
                    + SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * sh[:, 12]
                    + SH_C3[4] * x * (4.0 * zz - xx - yy) * sh[:, 13]
                    + SH_C3[5] * z * (xx - yy) * sh[:, 14]
                    + SH_C3[6] * x * (xx - 3.0 * yy) * sh[:, 15]
                )
    result = result + 0.5
    clamped = result < 0.0
    return torch.clamp(result, min=0.0), clamped
