"""StopThePop inverse-covariance payload on torch tensors.

Port of the part of ``stopthepop_tpu/ops/stopthepop.py`` that preprocess
needs: the packed inverse covariance ("cov3d_inv9" [..., 9]) with rows
(xx, xy, xz), (yy, yz, zz), u = Sigma^-1 (mean - campos) — the reference's
payload (forward.cu:208-220) minus its padding lanes — and the tile-based
culling test (``max_contrib_power_rect``, ``tile_rect_bounds``), the exact
per-ray depth of the k-buffer sort mode (``depth_along_ray``) and the
per-tile depth of the PTD_CENTER / PTD_MAX stream orders
(``per_tile_depth``).
"""

from __future__ import annotations

import torch

from ..constants import PER_TILE_DEPTH_BIAS, RAY_DEPTH_DEN_FLOOR, TILE_X, TILE_Y
from .covariance import compute_inv_cov3d
from .transforms import compute_view_ray


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


def depth_along_ray(cov3d_inv9, viewdir):
    """Depth of the max-contribution point of a Gaussian along a world ray.

    t* = (u . d) / (d^T Sigma^-1 d), with the reference's denominator floor
    (stopthepop_common.cuh:44-55). Broadcasts over leading dims; the
    operation order is the k-buffer kernels'.
    """
    xx, xy, xz, yy, yz, zz = (cov3d_inv9[..., i] for i in range(6))
    ux, uy, uz = (cov3d_inv9[..., 6 + i] for i in range(3))
    dx, dy, dz = viewdir[..., 0], viewdir[..., 1], viewdir[..., 2]
    num = ux * dx + uy * dy + uz * dz
    den = (
        xx * dx * dx
        + yy * dy * dy
        + zz * dz * dz
        + 2.0 * (xy * dx * dy + xz * dx * dz + yz * dy * dz)
    )
    return num / torch.clamp(den, min=RAY_DEPTH_DEN_FLOOR)


def per_tile_depth(target_pos, cov3d_inv9, campos, w, h, inverse_vp):
    """Per-tile sort depth: ray through target_pos, biased and floored.

    Reference: stopthepop_common.cuh:439-453 —
    depth = max(0, depthAlongRay(ray to target) + 8).
    """
    viewdir = compute_view_ray(target_pos, w, h, inverse_vp, campos)
    return torch.clamp(depth_along_ray(cov3d_inv9, viewdir) + PER_TILE_DEPTH_BIAS,
                       min=0.0)


def evaluate_opacity_factor(dx, dy, conic):
    """0.5 (a dx^2 + c dy^2) + b dx dy. stopthepop_common.cuh:76-79."""
    return 0.5 * (conic[..., 0] * dx * dx + conic[..., 2] * dy * dy) + conic[
        ..., 1
    ] * dx * dy


def max_contrib_power_rect(conic_opac, mean2d, rect_min, rect_max,
                           patch_w=TILE_X - 1, patch_h=TILE_Y - 1):
    """Minimum Gaussian power over an axis-aligned pixel rect.

    Branch-free form of stopthepop_common.cuh:130-174
    (max_contrib_power_rect_gaussian_float), operation for operation as in
    the JAX package: clamp the 1D line parameter from the nearest rect
    corner along each edge. Returns (max_contrib_power [...],
    max_pos [..., 2]). Power 0 means the mean lies inside the rect.
    """
    mx, my = mean2d[..., 0], mean2d[..., 1]
    co_x, co_y, co_z = conic_opac[..., 0], conic_opac[..., 1], conic_opac[..., 2]

    x_left = (rect_min[..., 0] - mx) > 0.0
    y_above = (rect_min[..., 1] - my) > 0.0
    not_in_x = x_left | (mx > rect_max[..., 0])
    not_in_y = y_above | (my > rect_max[..., 1])
    outside = not_in_x | not_in_y

    px = torch.where(x_left, rect_min[..., 0], rect_max[..., 0])
    py = torch.where(y_above, rect_min[..., 1], rect_max[..., 1])
    dx = torch.where(x_left, float(patch_w), -float(patch_w))
    dy = torch.where(y_above, float(patch_h), -float(patch_h))

    diffx = mx - px
    diffy = my - py

    tx = torch.where(
        not_in_y,
        torch.clamp((dx * co_x * diffx + dx * co_y * diffy) / (dx * dx * co_x),
                    0.0, 1.0),
        0.0,
    )
    ty = torch.where(
        not_in_x,
        torch.clamp((dy * co_y * diffx + dy * co_z * diffy) / (dy * dy * co_z),
                    0.0, 1.0),
        0.0,
    )
    cand_x = px + tx * dx
    cand_y = py + ty * dy
    max_x = torch.where(outside, cand_x, mx)
    max_y = torch.where(outside, cand_y, my)

    power = torch.where(
        outside,
        evaluate_opacity_factor(mx - max_x, my - max_y, conic_opac),
        0.0,
    )
    return power, torch.stack([max_x, max_y], dim=-1)


def tile_rect_bounds(tx, ty, tile_x=TILE_X, tile_y=TILE_Y):
    """Pixel-space (min, max) corners of tile (tx, ty) as used for culling.

    Reference: stopthepop_common.cuh:429-430 — max corner is inclusive
    ((x+1)*16 - 1).
    """
    tile_min = torch.stack([tx * tile_x, ty * tile_y], dim=-1).to(torch.float32)
    tile_max = torch.stack(
        [(tx + 1) * tile_x - 1, (ty + 1) * tile_y - 1], dim=-1
    ).to(torch.float32)
    return tile_min, tile_max


def pack_inv_cov3d(scales, scale_modifier, rotations, means3d, campos):
    """[..., 9] packed Sigma^-1 rows + Sigma^-1 (mean - campos).

    Reference: forward.cu:208-220.
    """
    inv6 = compute_inv_cov3d(scales, scale_modifier, rotations)
    return pack_inv_cov3d_from_inv6(inv6, means3d, campos)
