"""Gaussian covariance math on torch tensors.

Port of ``stopthepop_tpu/ops/covariance.py``: re-derivations of
forward_common.h (computeCov3D/computeCov2D/dilateCov2D/computeConicOpacity)
and stopthepop_common.cuh:13-41 (computeInvCov3D), in row-vector math.

Conventions:
  * quaternions are (r, x, y, z) and NOT normalized here — the reference also
    skips normalization (forward_common.h:158) and relies on the caller.
  * cov3d is packed upper-triangular: (xx, xy, xz, yy, yz, zz).

The 3x3 products are written as component vectors, so no float32 matrix
product (and no TF32 rounding) is involved.
"""

from __future__ import annotations

import torch

from ..constants import (
    DILATION_H_VAR,
    EWA_DET_FLOOR,
    FOV_CLAMP,
    INV_COV_SCALE_FLOOR,
)


def _rotmat_rows(q):
    """Rotation matrix entries as 9 [...] tensors (row-major)."""
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return (
        1.0 - 2.0 * (y * y + z * z),
        2.0 * (x * y - r * z),
        2.0 * (x * z + r * y),
        2.0 * (x * y + r * z),
        1.0 - 2.0 * (x * x + z * z),
        2.0 * (y * z - r * x),
        2.0 * (x * z - r * y),
        2.0 * (y * z + r * x),
        1.0 - 2.0 * (x * x + y * y),
    )


def quat_to_rotmat(q):
    """Rotation matrix from (r, x, y, z) quaternions [..., 4] -> [..., 3, 3].

    Matches the reference's effective world rotation (forward_common.h:165-169).
    """
    m = _rotmat_rows(q)
    return torch.stack(m, dim=-1).reshape(*q.shape[:-1], 3, 3)


def unpack_sym3(c):
    """Packed [..., 6] -> full symmetric [..., 3, 3]."""
    xx, xy, xz, yy, yz, zz = (c[..., i] for i in range(6))
    return torch.stack([xx, xy, xz, xy, yy, yz, xz, yz, zz], dim=-1).reshape(
        *c.shape[:-1], 3, 3
    )


def _rot_diag_rot_t(q, d):
    """Packed symmetric R diag(d) R^T; sigma_ik = sum_j R_ij d_j R_kj."""
    m = _rotmat_rows(q)
    d0, d1, d2 = d[..., 0], d[..., 1], d[..., 2]
    rows = ((m[0], m[1], m[2]), (m[3], m[4], m[5]), (m[6], m[7], m[8]))

    def entry(i, k):
        a, b, c = rows[i]
        e, f, g = rows[k]
        return d0 * a * e + d1 * b * f + d2 * c * g

    return torch.stack(
        [entry(0, 0), entry(0, 1), entry(0, 2),
         entry(1, 1), entry(1, 2), entry(2, 2)],
        dim=-1,
    )


def compute_cov3d(scales, scale_modifier, rotations):
    """World covariance Sigma = R diag(s^2) R^T, packed [..., 6].

    Reference: forward_common.h:149-183 (computeCov3D).
    """
    s2 = torch.square(scales * scale_modifier)
    return _rot_diag_rot_t(rotations, s2)


def compute_inv_cov3d(scales, scale_modifier, rotations):
    """Inverse world covariance Sigma^-1 = R diag(1/s^2) R^T, packed [..., 6].

    The scale floor matches stopthepop_common.cuh:19-21.
    """
    s = torch.clamp(scales, min=INV_COV_SCALE_FLOOR) * scale_modifier
    inv_s2 = 1.0 / torch.square(s)
    return _rot_diag_rot_t(rotations, inv_s2)


def compute_cov2d(p_view, focal_x, focal_y, tan_fovx, tan_fovy, cov3d,
                  viewmatrix):
    """EWA-splatting 2D covariance (before dilation), [..., 3] = (xx, xy, yy).

    Reference: forward_common.h:72-106 (computeCov2D), with the 1.3 FOV clamp
    on the Jacobian's view position. cov2d = J R_w2v Sigma R_w2v^T J^T with
    R_w2v = viewmatrix[:3,:3]^T.
    """
    tx, ty, tz = p_view[..., 0], p_view[..., 1], p_view[..., 2]
    limx = FOV_CLAMP * tan_fovx
    limy = FOV_CLAMP * tan_fovy
    tx = torch.clamp(tx / tz, -limx, limx) * tz
    ty = torch.clamp(ty / tz, -limy, limy) * tz

    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    j00 = focal_x * inv_z
    j02 = -focal_x * tx * inv_z2
    j11 = focal_y * inv_z
    j12 = -focal_y * ty * inv_z2

    W = viewmatrix[:3, :3].T  # R_w2v
    t0 = [j00 * W[0, col] + j02 * W[2, col] for col in range(3)]
    t1 = [j11 * W[1, col] + j12 * W[2, col] for col in range(3)]

    xx, xy, xz, yy, yz, zz = (cov3d[..., i] for i in range(6))

    def sigma_dot(v):  # Sigma @ v for component vector v
        return (
            xx * v[0] + xy * v[1] + xz * v[2],
            xy * v[0] + yy * v[1] + yz * v[2],
            xz * v[0] + yz * v[1] + zz * v[2],
        )

    s0 = sigma_dot(t0)
    c00 = t0[0] * s0[0] + t0[1] * s0[1] + t0[2] * s0[2]
    c01 = t1[0] * s0[0] + t1[1] * s0[1] + t1[2] * s0[2]
    s1 = sigma_dot(t1)
    c11 = t1[0] * s1[0] + t1[1] * s1[1] + t1[2] * s1[2]
    return torch.stack([c00, c01, c11], dim=-1)


def dilate_cov2d(cov2d, proper_ewa_scaling: bool):
    """Low-pass dilation (+0.3 px variance) and Mip-Splatting compensation.

    Reference: forward_common.h:108-131 (dilateCov2D).
    Returns (dilated cov2d [..., 3], det_dilated [...], scaling factor [...]).
    """
    xx = cov2d[..., 0] + DILATION_H_VAR
    xy = cov2d[..., 1]
    yy = cov2d[..., 2] + DILATION_H_VAR
    det_dilated = xx * yy - xy * xy
    if proper_ewa_scaling:
        det_orig = cov2d[..., 0] * cov2d[..., 2] - cov2d[..., 1] * cov2d[..., 1]
        factor = torch.sqrt(torch.clamp(det_orig / det_dilated,
                                        min=EWA_DET_FLOOR))
    else:
        factor = torch.ones_like(det_dilated)
    return torch.stack([xx, xy, yy], dim=-1), det_dilated, factor


def conic_opacity(cov2d, opacity, det, convolution_scaling_factor):
    """Invert the 2D covariance into a conic, fused with opacity [..., 4].

    Reference: forward_common.h:133-144 (computeConicOpacity).
    """
    det_inv = 1.0 / det
    return torch.stack(
        [
            cov2d[..., 2] * det_inv,
            -cov2d[..., 1] * det_inv,
            cov2d[..., 0] * det_inv,
            opacity * convolution_scaling_factor,
        ],
        dim=-1,
    )
