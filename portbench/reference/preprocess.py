"""Per-Gaussian preprocess: cull, project, colour (plain PyTorch).

A frozen copy of the program's preprocess (the 3DGS reference's
forward.cu:68-229 with StopThePop's payload) for the options the
benchmark's configurations use: scales and rotations (no precomputed
covariance), SH colours, Z_DEPTH or DISTANCE global depth, rect and
tight-opacity bounding, no proper EWA scaling. Matrices are in the
torch-3DGS transposed convention (``p_out = [p, 1] @ M``); every 3x3 and
4x4 product is written out component by component, so no matrix
multiplication (and no TF32) is involved.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

TILE = 16
ALPHA_THRESHOLD = 1.0 / 255.0
ALPHA_MAX = 0.99
T_THRESHOLD = 1.0e-4
DILATION_H_VAR = 0.3
EXTENT_SIGMA = 3.33
MIN_LAMBDA = 0.01
NEAR_Z = 0.2
FOV_CLAMP = 1.3
INV_COV_SCALE_FLOOR = 1.0e-3
RAY_DEPTH_DEN_FLOOR = 1.0e-5
NDC_W_EPS = 1.0e-7

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


class Prep(NamedTuple):
    valid: torch.Tensor          # [P] bool
    mean2d: torch.Tensor         # [P, 2] pixel-space centre
    depth: torch.Tensor          # [P] global sort depth
    conic_opacity: torch.Tensor  # [P, 4] (a, b, c, opacity)
    rgb: torch.Tensor            # [P, 3]
    rect_min: torch.Tensor       # [P, 2] int32 bin-space rect (inclusive)
    rect_max: torch.Tensor       # [P, 2] int32 bin-space rect (exclusive)
    tiles_touched: torch.Tensor  # [P] int32 (0 if culled)
    cov3d_inv9: torch.Tensor     # [P, 9] Sigma^-1 packed, Sigma^-1 (mu - cam)
    opacity_power_threshold: torch.Tensor  # [P] log(opacity / (1/255))


def _affine(p, m, cols):
    return (p[..., 0:1] * m[0, cols] + p[..., 1:2] * m[1, cols]
            + p[..., 2:3] * m[2, cols] + m[3, cols])


def world2ndc(p, viewproj):
    p_hom = _affine(p, viewproj, slice(0, 4))
    return p_hom[..., :3] * (1.0 / (p_hom[..., 3:4] + NDC_W_EPS))


def ndc2pix(v, size):
    return ((v + 1.0) * size - 1.0) * 0.5


def compute_view_ray(pix, w, h, inverse_vp, campos):
    """Normalized world ray through the pixel coordinate ``pix`` [..., 2]."""
    ndc_x = pix[..., 0] * (2.0 / w) - 1.0
    ndc_y = pix[..., 1] * (2.0 / h) - 1.0
    p = (ndc_x[..., None] * inverse_vp[0] + ndc_y[..., None] * inverse_vp[1]
         + inverse_vp[3])
    d = p[..., :3] / p[..., 3:4] - campos
    norm = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
                      + d[..., 2] * d[..., 2])
    return d / norm[..., None]


def depth_along_ray(cov3d_inv9, viewdir):
    """t* = (u . d) / (d^T Sigma^-1 d), the depth of a Gaussian's largest
    contribution along a ray (stopthepop_common.cuh:44-55)."""
    xx, xy, xz, yy, yz, zz = (cov3d_inv9[..., i] for i in range(6))
    ux, uy, uz = (cov3d_inv9[..., 6 + i] for i in range(3))
    dx, dy, dz = viewdir[..., 0], viewdir[..., 1], viewdir[..., 2]
    num = ux * dx + uy * dy + uz * dz
    den = (xx * dx * dx + yy * dy * dy + zz * dz * dz
           + 2.0 * (xy * dx * dy + xz * dx * dz + yz * dy * dz))
    return num / torch.clamp(den, min=RAY_DEPTH_DEN_FLOOR)


def _rot_diag_rot_t(q, d):
    """Packed symmetric R diag(d) R^T of (r, x, y, z) quaternions."""
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    m = (1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - r * z),
         2.0 * (x * z + r * y), 2.0 * (x * y + r * z),
         1.0 - 2.0 * (x * x + z * z), 2.0 * (y * z - r * x),
         2.0 * (x * z - r * y), 2.0 * (y * z + r * x),
         1.0 - 2.0 * (x * x + y * y))
    rows = ((m[0], m[1], m[2]), (m[3], m[4], m[5]), (m[6], m[7], m[8]))
    d0, d1, d2 = d[..., 0], d[..., 1], d[..., 2]

    def entry(i, k):
        a, b, c = rows[i]
        e, f, g = rows[k]
        return d0 * a * e + d1 * b * f + d2 * c * g

    return torch.stack([entry(0, 0), entry(0, 1), entry(0, 2),
                        entry(1, 1), entry(1, 2), entry(2, 2)], dim=-1)


def _cov2d(p_view, focal_x, focal_y, tan_fovx, tan_fovy, cov3d, viewmatrix):
    """EWA 2D covariance (xx, xy, yy) before dilation (forward_common.h)."""
    tx, ty, tz = p_view[..., 0], p_view[..., 1], p_view[..., 2]
    tx = torch.clamp(tx / tz, -FOV_CLAMP * tan_fovx, FOV_CLAMP * tan_fovx) * tz
    ty = torch.clamp(ty / tz, -FOV_CLAMP * tan_fovy, FOV_CLAMP * tan_fovy) * tz
    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    j00, j02 = focal_x * inv_z, -focal_x * tx * inv_z2
    j11, j12 = focal_y * inv_z, -focal_y * ty * inv_z2
    W = viewmatrix[:3, :3].T
    t0 = [j00 * W[0, c] + j02 * W[2, c] for c in range(3)]
    t1 = [j11 * W[1, c] + j12 * W[2, c] for c in range(3)]
    xx, xy, xz, yy, yz, zz = (cov3d[..., i] for i in range(6))

    def sigma_dot(v):
        return (xx * v[0] + xy * v[1] + xz * v[2],
                xy * v[0] + yy * v[1] + yz * v[2],
                xz * v[0] + yz * v[1] + zz * v[2])

    s0 = sigma_dot(t0)
    c00 = t0[0] * s0[0] + t0[1] * s0[1] + t0[2] * s0[2]
    c01 = t1[0] * s0[0] + t1[1] * s0[1] + t1[2] * s0[2]
    s1 = sigma_dot(t1)
    c11 = t1[0] * s1[0] + t1[1] * s1[1] + t1[2] * s1[2]
    return torch.stack([c00, c01, c11], dim=-1)


def eval_sh(sh, means3d, campos, degree: int):
    """max(SH colour + 0.5, 0) of every Gaussian (forward_common.h:20-70)."""
    d = means3d - campos
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    x, y, z = d[..., 0:1], d[..., 1:2], d[..., 2:3]
    result = SH_C0 * sh[:, 0]
    if degree > 0:
        result = (result - SH_C1 * y * sh[:, 1] + SH_C1 * z * sh[:, 2]
                  - SH_C1 * x * sh[:, 3])
        if degree > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            result = (result + SH_C2[0] * xy * sh[:, 4]
                      + SH_C2[1] * yz * sh[:, 5]
                      + SH_C2[2] * (2.0 * zz - xx - yy) * sh[:, 6]
                      + SH_C2[3] * xz * sh[:, 7]
                      + SH_C2[4] * (xx - yy) * sh[:, 8])
            if degree > 2:
                result = (
                    result
                    + SH_C3[0] * y * (3.0 * xx - yy) * sh[:, 9]
                    + SH_C3[1] * xy * z * sh[:, 10]
                    + SH_C3[2] * y * (4.0 * zz - xx - yy) * sh[:, 11]
                    + SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * sh[:, 12]
                    + SH_C3[4] * x * (4.0 * zz - xx - yy) * sh[:, 13]
                    + SH_C3[5] * z * (xx - yy) * sh[:, 14]
                    + SH_C3[6] * x * (xx - 3.0 * yy) * sh[:, 15])
    return torch.clamp(result + 0.5, min=0.0)


def preprocess(means3d, scales, rotations, opacities, shs, cam, *, width,
               height, sh_degree, tile, rect_bounding, tight_opacity_bounding,
               distance_depth=False):
    """All Gaussians in one masked pass; ``cam`` holds ``viewmatrix``,
    ``projmatrix``, ``campos`` (tensors), ``tanfovx`` and ``tanfovy``;
    ``tile`` = (tile_x, tile_y) is the binning tile of the rects. Culled
    Gaussians flow through the math with their view position replaced by
    (0, 0, 1) and leave with ``tiles_touched`` 0."""
    tile_x, tile_y = tile
    grid_x, grid_y = -(-width // tile_x), -(-height // tile_y)
    focal_y = height / (2.0 * cam.tanfovy)
    focal_x = width / (2.0 * cam.tanfovx)
    viewmatrix, campos = cam.viewmatrix, cam.campos
    p_view = _affine(means3d, viewmatrix, slice(0, 3))
    visible = p_view[..., 2] > NEAR_Z
    p_view = torch.where(visible[:, None], p_view,
                         p_view.new_tensor([0.0, 0.0, 1.0]))
    cov3d = _rot_diag_rot_t(rotations, torch.square(scales))
    raw = _cov2d(p_view, focal_x, focal_y, cam.tanfovx, cam.tanfovy, cov3d,
                 viewmatrix)
    xx, xy, yy = raw[..., 0] + DILATION_H_VAR, raw[..., 1], raw[..., 2] + DILATION_H_VAR
    det = xx * yy - xy * xy
    valid = visible & (det != 0.0)
    det = torch.where(det == 0.0, torch.ones_like(det), det)
    det_inv = 1.0 / det
    co = torch.stack([yy * det_inv, -xy * det_inv, xx * det_inv, opacities],
                     dim=-1)
    valid = valid & (co[:, 3] >= ALPHA_THRESHOLD)
    opt = torch.log(torch.clamp(co[:, 3], min=ALPHA_THRESHOLD) / ALPHA_THRESHOLD)
    if tight_opacity_bounding:
        extent = torch.clamp(torch.sqrt(2.0 * opt), max=EXTENT_SIGMA)
    else:
        extent = torch.full_like(opt, EXTENT_SIGMA)
    mid = 0.5 * (xx + yy)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=MIN_LAMBDA))
    radius = extent * torch.sqrt(lam)
    valid = valid & (radius > 0.0)
    p_proj = world2ndc(means3d, cam.projmatrix)
    mean2d = torch.stack([ndc2pix(p_proj[:, 0], width),
                          ndc2pix(p_proj[:, 1], height)], dim=-1)
    if rect_bounding:
        ext = torch.stack([torch.minimum(extent * torch.sqrt(xx), radius),
                           torch.minimum(extent * torch.sqrt(yy), radius)], -1)
    else:
        ext = torch.stack([radius, radius], dim=-1)
    size = mean2d.new_tensor([float(tile_x), float(tile_y)])
    hi_clamp = torch.tensor([grid_x, grid_y], device=means3d.device)
    lo = torch.minimum(torch.clamp(torch.floor((mean2d - ext) / size), min=0),
                       hi_clamp).to(torch.int32)
    hi = torch.minimum(torch.clamp(torch.ceil((mean2d + ext) / size), min=0),
                       hi_clamp).to(torch.int32)
    count = torch.prod(torch.clamp(hi - lo, min=0), dim=-1).to(torch.int32)
    valid = valid & (count > 0)
    rgb = eval_sh(shs, means3d, campos, sh_degree)
    s = torch.clamp(scales, min=INV_COV_SCALE_FLOOR)
    inv6 = _rot_diag_rot_t(rotations, 1.0 / torch.square(s))
    v = means3d - campos
    u = torch.stack([inv6[..., 0] * v[..., 0] + inv6[..., 1] * v[..., 1] + inv6[..., 2] * v[..., 2],
                     inv6[..., 1] * v[..., 0] + inv6[..., 3] * v[..., 1] + inv6[..., 4] * v[..., 2],
                     inv6[..., 2] * v[..., 0] + inv6[..., 4] * v[..., 1] + inv6[..., 5] * v[..., 2]],
                    dim=-1)
    depth = (torch.linalg.norm(means3d - campos, dim=-1) if distance_depth
             else p_view[:, 2])
    return Prep(valid=valid, mean2d=mean2d, depth=depth, conic_opacity=co,
                rgb=rgb, rect_min=lo, rect_max=hi,
                tiles_touched=torch.where(valid, count, torch.zeros_like(count)),
                cov3d_inv9=torch.cat([inv6, u], dim=-1),
                opacity_power_threshold=opt)
