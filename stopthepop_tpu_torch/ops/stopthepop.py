"""StopThePop inverse-covariance payload on torch tensors.

Port of the part of ``stopthepop_tpu/ops/stopthepop.py`` that preprocess
needs: the packed inverse covariance ("cov3d_inv9" [..., 9]) with rows
(xx, xy, xz), (yy, yz, zz), u = Sigma^-1 (mean - campos) — the reference's
payload (forward.cu:208-220) minus its padding lanes. The per-ray and
per-tile depth functions come with the per-tile-depth sort orders.
"""

from __future__ import annotations

import torch

from .covariance import compute_inv_cov3d


def pack_inv_cov3d_from_inv6(inv6, means3d, campos):
    """[..., 9]: packed Sigma^-1 followed by Sigma^-1 (mean - campos)."""
    xx, xy, xz, yy, yz, zz = (inv6[..., i] for i in range(6))
    v = means3d - campos
    vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]
    u = torch.stack(
        [
            xx * vx + xy * vy + xz * vz,
            xy * vx + yy * vy + yz * vz,
            xz * vx + yz * vy + zz * vz,
        ],
        dim=-1,
    )
    return torch.cat([inv6, u], dim=-1)


def pack_inv_cov3d(scales, scale_modifier, rotations, means3d, campos):
    """[..., 9] packed Sigma^-1 rows + Sigma^-1 (mean - campos).

    Reference: forward.cu:208-220.
    """
    inv6 = compute_inv_cov3d(scales, scale_modifier, rotations)
    return pack_inv_cov3d_from_inv6(inv6, means3d, campos)
