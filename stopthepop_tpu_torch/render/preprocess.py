"""Per-Gaussian preprocessing: cull, project, color (torch).

Port of ``stopthepop_tpu/render/preprocess.py`` (reference preprocess kernel,
forward.cu:68-229): one masked pass over all P Gaussians. Invalid Gaussians
keep flowing through the math with ``valid=False`` — their view position is
replaced by (0, 0, 1) so that 1/z stays finite — and are dropped by
``radii``/``tiles_touched`` at the end, exactly as in the JAX package.

Where no gradient is wanted, the inputs lie on a CUDA device and no
covariance is precomputed (``kernels/preprocess_fwd.py::takes_kernel``),
``preprocess`` computes every field in one launch of kernel K8 inside a
span ``stp/preprocess_kernel``, to the plain version's values. Everywhere
else the plain version below runs: on the CPU, under training's autograd
and with ``cov3d_precomp``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import GlobalSortOrder
from ..constants import ALPHA_THRESHOLD, EXTENT_SIGMA, MIN_LAMBDA, TILE_X, TILE_Y
from ..kernels.preprocess_fwd import preprocess_fwd, takes_kernel
from ..ops.covariance import (
    compute_cov2d,
    compute_cov3d,
    compute_inv_cov3d,
    conic_opacity,
    dilate_cov2d,
    unpack_sym3,
)
from ..ops.sh import eval_sh
from ..ops.stopthepop import pack_inv_cov3d_from_inv6
from ..ops.transforms import in_frustum, ndc2pix, world2ndc
from ..utils.profiling import span


class PreprocessOutput(NamedTuple):
    valid: torch.Tensor          # [P] bool — survives all culling
    p_view: torch.Tensor         # [P, 3] view-space position
    mean2d: torch.Tensor         # [P, 2] pixel-space center
    depth: torch.Tensor          # [P] global sort depth (z or distance)
    conic_opacity: torch.Tensor  # [P, 4] (a, b, c, opacity)
    rgb: torch.Tensor            # [P, 3]
    clamped: torch.Tensor        # [P, 3] bool SH clamp mask
    radius: torch.Tensor         # [P] float screen-space radius
    radii: torch.Tensor          # [P] int32 ceil(radius), 0 if culled
    rect_dims: torch.Tensor      # [P, 2] per-axis rect extents (pixels)
    rect_min: torch.Tensor       # [P, 2] int32 tile-space rect min (inclusive)
    rect_max: torch.Tensor       # [P, 2] int32 tile-space rect max (exclusive)
    tiles_touched: torch.Tensor  # [P] int32 rect tile count (0 if culled)
    cov3d_inv9: torch.Tensor     # [P, 9] packed Sigma^-1 + Sigma^-1(mu - cam)
    opacity_power_threshold: torch.Tensor  # [P] log(opacity / alpha_thresh)


def get_rect(mean2d, rect_dims, grid_x: int, grid_y: int,
             tile_x: int = TILE_X, tile_y: int = TILE_Y):
    """Tile-space bounding rect of a screen-space extent box, in binning
    tiles of ``tile_x`` x ``tile_y`` pixels.

    Reference: auxiliary.h:91-101 (getRect) — min inclusive, max exclusive,
    both clamped to [0, grid].
    """
    lo = torch.stack(
        [
            torch.clamp(torch.floor((mean2d[..., 0] - rect_dims[..., 0]) / tile_x), 0, grid_x),
            torch.clamp(torch.floor((mean2d[..., 1] - rect_dims[..., 1]) / tile_y), 0, grid_y),
        ],
        dim=-1,
    ).to(torch.int32)
    hi = torch.stack(
        [
            torch.clamp(torch.ceil((mean2d[..., 0] + rect_dims[..., 0]) / tile_x), 0, grid_x),
            torch.clamp(torch.ceil((mean2d[..., 1] + rect_dims[..., 1]) / tile_y), 0, grid_y),
        ],
        dim=-1,
    ).to(torch.int32)
    return lo, hi


def preprocess(
    means3d: torch.Tensor,
    opacities: torch.Tensor,
    *,
    scales: Optional[torch.Tensor] = None,
    rotations: Optional[torch.Tensor] = None,
    cov3d_precomp: Optional[torch.Tensor] = None,
    shs: Optional[torch.Tensor] = None,
    colors_precomp: Optional[torch.Tensor] = None,
    scale_modifier: float = 1.0,
    viewmatrix: torch.Tensor,
    projmatrix: torch.Tensor,
    campos: torch.Tensor,
    tanfovx: float,
    tanfovy: float,
    image_width: int,
    image_height: int,
    sh_degree: int = 0,
    sort_order: GlobalSortOrder = GlobalSortOrder.Z_DEPTH,
    rect_bounding: bool = False,
    tight_opacity_bounding: bool = False,
    proper_ewa_scaling: bool = False,
    tile_x: int = TILE_X,
    tile_y: int = TILE_Y,
) -> PreprocessOutput:
    """Preprocess all Gaussians in one masked pass.

    ``tile_x`` x ``tile_y`` is the binning tile (16x16, the reference's,
    by default; config.h:16-17): ``rect_min``, ``rect_max`` and
    ``tiles_touched`` count binning tiles. Kernel K8 computes the fields
    where ``takes_kernel`` allows it, ``preprocess_plain`` everywhere else.
    """
    if takes_kernel(means3d.device,
                    (means3d, opacities, scales, rotations, shs,
                     colors_precomp, viewmatrix, projmatrix, campos),
                    cov3d_precomp):
        with span("preprocess_kernel"):
            return PreprocessOutput(*preprocess_fwd(
                means3d, opacities, scales=scales, rotations=rotations,
                shs=shs, colors_precomp=colors_precomp,
                scale_modifier=scale_modifier, viewmatrix=viewmatrix,
                projmatrix=projmatrix, campos=campos, tanfovx=tanfovx,
                tanfovy=tanfovy, image_width=image_width,
                image_height=image_height, sh_degree=sh_degree,
                distance_order=sort_order == GlobalSortOrder.DISTANCE,
                rect_bounding=rect_bounding,
                tight_opacity_bounding=tight_opacity_bounding,
                proper_ewa_scaling=proper_ewa_scaling, tile_x=tile_x,
                tile_y=tile_y))
    return preprocess_plain(
        means3d, opacities, scales=scales, rotations=rotations,
        cov3d_precomp=cov3d_precomp, shs=shs, colors_precomp=colors_precomp,
        scale_modifier=scale_modifier, viewmatrix=viewmatrix,
        projmatrix=projmatrix, campos=campos, tanfovx=tanfovx,
        tanfovy=tanfovy, image_width=image_width, image_height=image_height,
        sh_degree=sh_degree, sort_order=sort_order,
        rect_bounding=rect_bounding,
        tight_opacity_bounding=tight_opacity_bounding,
        proper_ewa_scaling=proper_ewa_scaling, tile_x=tile_x, tile_y=tile_y)


def preprocess_plain(
    means3d: torch.Tensor,
    opacities: torch.Tensor,
    *,
    scales: Optional[torch.Tensor] = None,
    rotations: Optional[torch.Tensor] = None,
    cov3d_precomp: Optional[torch.Tensor] = None,
    shs: Optional[torch.Tensor] = None,
    colors_precomp: Optional[torch.Tensor] = None,
    scale_modifier: float = 1.0,
    viewmatrix: torch.Tensor,
    projmatrix: torch.Tensor,
    campos: torch.Tensor,
    tanfovx: float,
    tanfovy: float,
    image_width: int,
    image_height: int,
    sh_degree: int = 0,
    sort_order: GlobalSortOrder = GlobalSortOrder.Z_DEPTH,
    rect_bounding: bool = False,
    tight_opacity_bounding: bool = False,
    proper_ewa_scaling: bool = False,
    tile_x: int = TILE_X,
    tile_y: int = TILE_Y,
) -> PreprocessOutput:
    """The plain version of ``preprocess``, in torch operations: the path
    of the CPU, of gradients and of ``cov3d_precomp``, and what K8 is held
    against on the card."""
    P = means3d.shape[0]
    opacities = opacities.reshape(P)
    grid_x = (image_width + tile_x - 1) // tile_x
    grid_y = (image_height + tile_y - 1) // tile_y
    # Focal lengths from tan-fov, reference rasterizer_impl.cu:251-252.
    focal_y = image_height / (2.0 * tanfovy)
    focal_x = image_width / (2.0 * tanfovx)

    visible, p_view = in_frustum(means3d, viewmatrix)
    # Keep the math finite for culled Gaussians (z <= 0.2 would blow up 1/z).
    p_view_safe = torch.where(
        visible[:, None], p_view, p_view.new_tensor([0.0, 0.0, 1.0])
    )

    if cov3d_precomp is not None:
        cov3d = cov3d_precomp
    else:
        cov3d = compute_cov3d(scales, scale_modifier, rotations)

    cov2d_raw = compute_cov2d(
        p_view_safe, focal_x, focal_y, tanfovx, tanfovy, cov3d, viewmatrix
    )
    cov2d, det, conv_factor = dilate_cov2d(cov2d_raw, proper_ewa_scaling)
    valid = visible & (det != 0.0)
    det_safe = torch.where(det == 0.0, torch.ones_like(det), det)

    co = conic_opacity(cov2d, opacities, det_safe, conv_factor)
    valid = valid & (co[:, 3] >= ALPHA_THRESHOLD)

    opw_safe = torch.clamp(co[:, 3], min=ALPHA_THRESHOLD)
    opacity_power_threshold = torch.log(opw_safe / ALPHA_THRESHOLD)

    if tight_opacity_bounding:
        extent = torch.clamp(torch.sqrt(2.0 * opacity_power_threshold),
                             max=EXTENT_SIGMA)
    else:
        extent = torch.full_like(opacity_power_threshold, EXTENT_SIGMA)

    mid = 0.5 * (cov2d[:, 0] + cov2d[:, 2])
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det_safe, min=MIN_LAMBDA))
    radius = extent * torch.sqrt(lam)
    valid = valid & (radius > 0.0)

    p_proj = world2ndc(means3d, projmatrix)
    mean2d = torch.stack(
        [ndc2pix(p_proj[:, 0], image_width), ndc2pix(p_proj[:, 1], image_height)],
        dim=-1,
    )

    if rect_bounding:
        # Per-axis bounding (forward.cu:173-175).
        ext_x = torch.minimum(extent * torch.sqrt(cov2d[:, 0]), radius)
        ext_y = torch.minimum(extent * torch.sqrt(cov2d[:, 2]), radius)
    else:
        ext_x = radius
        ext_y = radius
    rect_dims = torch.stack([ext_x, ext_y], dim=-1)

    rect_min, rect_max = get_rect(mean2d, rect_dims, grid_x, grid_y,
                                  tile_x, tile_y)
    tile_count = torch.prod(
        torch.clamp(rect_max - rect_min, min=0), dim=-1
    ).to(torch.int32)
    valid = valid & (tile_count > 0)

    if colors_precomp is not None:
        rgb = colors_precomp
        clamped = torch.zeros((P, 3), dtype=torch.bool, device=means3d.device)
    else:
        rgb, clamped = eval_sh(shs, means3d, campos, sh_degree)

    # Inverse covariance payload for per-ray depths. Prefer the scale/rot
    # path (it has the reference's 1e-3 scale floor); else invert the
    # precomputed covariance.
    if scales is not None and rotations is not None:
        inv6 = compute_inv_cov3d(scales, scale_modifier, rotations)
    else:
        sigma = unpack_sym3(cov3d)
        inv = torch.linalg.inv(
            sigma + 1e-8 * torch.eye(3, dtype=sigma.dtype, device=sigma.device)
        )
        inv6 = torch.stack(
            [
                inv[:, 0, 0], inv[:, 0, 1], inv[:, 0, 2],
                inv[:, 1, 1], inv[:, 1, 2], inv[:, 2, 2],
            ],
            dim=-1,
        )
    cov3d_inv9 = pack_inv_cov3d_from_inv6(inv6, means3d, campos)

    if sort_order == GlobalSortOrder.DISTANCE:
        depth = torch.linalg.norm(means3d - campos, dim=-1)
    else:
        # VIEWSPACE_Z for Z_DEPTH (and the global depth the per-tile-depth
        # orders keep for parity, forward.cu:223).
        depth = p_view_safe[:, 2]

    radii = torch.where(valid, torch.ceil(radius), torch.zeros_like(radius)).to(torch.int32)
    tiles_touched = torch.where(valid, tile_count, torch.zeros_like(tile_count))

    return PreprocessOutput(
        valid=valid,
        p_view=p_view_safe,
        mean2d=mean2d,
        depth=depth,
        conic_opacity=co,
        rgb=rgb,
        clamped=clamped,
        radius=radius,
        radii=radii,
        rect_dims=rect_dims,
        rect_min=rect_min,
        rect_max=rect_max,
        tiles_touched=tiles_touched,
        cov3d_inv9=cov3d_inv9,
        opacity_power_threshold=opacity_power_threshold,
    )
