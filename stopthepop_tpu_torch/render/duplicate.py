"""Gaussian→tile pair expansion ("duplication") and sort (torch).

Port of the semantics of ``stopthepop_tpu/render/duplicate.py``
(``expand_pairs``, ``sort_expanded``, ``build_pairs``, ``count_pairs``,
``rect_histogram``); the reference's duplicateWithKeys (forward.cu:25-65).

The pair count is dynamic, as in the reference: ``num_rendered`` is read back
to the host once per frame (rasterizer_impl.cu:316-321) and every buffer has
exactly that length. There is no static capacity, padding pool, segment
alignment or rank key: those exist in the JAX package for the TPU's static
shapes and sort costs.

The pair stream is Gaussian-major: Gaussian g emits one pair per tile of its
rect, row-major within the rect, in ascending g. The stable (tile, depth)
sort then breaks depth ties by ascending Gaussian id, as ``jax.lax.sort`` does
on the same stream. With ``tile_based_culling`` the pairs whose tile the
Gaussian cannot reach above the 1/255 alpha threshold are dropped before the
sort (JAX ``duplicate.py:342-352``); the stream stays Gaussian-major.
Tiles here are binning tiles of ``tile_x`` x ``tile_y`` pixels (16x16 by
default): the culling test covers the binning tile's pixel rect and the
PTD_CENTER / PTD_MAX depth is taken at its centre or its nearest point, as
in JAX ``duplicate.py:346-361``.

For the backward, the buffer keeps the sort permutation (``orig_slot``) and
the Gaussian-major run offsets (``gauss_offsets``): unsorting per-pair
cotangents with ``orig_slot`` lays every Gaussian's pairs out as one
contiguous run, which one segmented sum reduces (the semantics of the JAX
package's ``make_segment_gather`` residuals, without its TPU devices).

``build_pairs`` builds the same buffer, bit for bit, with the kernels of
``kernels/pairs.py`` where ``takes_kernel`` allows it (CUDA tensors, Z_DEPTH
or DISTANCE, no tile-based culling; views and training steps alike, since
no gradient flows through the pairs); ``expand_pairs`` and
``sort_expanded`` are the path everywhere else.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import GlobalSortOrder
from ..constants import TILE_X, TILE_Y
from ..kernels.pairs import duplicate_with_keys, sort_and_identify, takes_kernel
from ..ops.sort import identify_tile_ranges, sort_pairs
from ..ops.stopthepop import max_contrib_power_rect, per_tile_depth, tile_rect_bounds
from ..utils.profiling import span
from .preprocess import PreprocessOutput

PER_TILE_ORDERS = (GlobalSortOrder.PTD_CENTER, GlobalSortOrder.PTD_MAX)


class PairBuffer(NamedTuple):
    tile_id: torch.Tensor   # [N] int32, sorted
    depth: torch.Tensor     # [N] float32, sorted within tiles
    gauss_id: torch.Tensor  # [N] int32 Gaussian index
    starts: torch.Tensor    # [num_tiles] int32 per-tile range start
    ends: torch.Tensor      # [num_tiles] int32 per-tile range end
    num_rendered: int       # N, the exact pair count
    orig_slot: torch.Tensor  # [N] int64 expansion index of each sorted slot
    gauss_offsets: torch.Tensor  # [P + 1] int64 Gaussian-major run offsets


def rect_histogram(prep: PreprocessOutput, grid_x: int, grid_y: int):
    """Exact per-tile pair counts [T] int32 without touching the pair domain.

    counts[ty, tx] = sum_g 1[rect_g covers (tx, ty)], a product of two 0/1
    indicator matrices contracted over Gaussians. The indicators are exact
    in any float format and the sums are exact below 2^24 in float32.
    """
    dev = prep.rect_min.device
    tx = torch.arange(grid_x, dtype=torch.int32, device=dev)
    ty = torch.arange(grid_y, dtype=torch.int32, device=dev)
    a = (
        (tx[None, :] >= prep.rect_min[:, :1])
        & (tx[None, :] < prep.rect_max[:, :1])
        & prep.valid[:, None]
    ).to(torch.float32)  # [P, gx]
    b = (
        (ty[None, :] >= prep.rect_min[:, 1:2])
        & (ty[None, :] < prep.rect_max[:, 1:2])
    ).to(torch.float32)  # [P, gy]
    return (b.T @ a).reshape(-1).to(torch.int32)


def count_pairs(prep: PreprocessOutput) -> torch.Tensor:
    """Exact number of (Gaussian, tile) pairs the rect expansion produces."""
    return prep.tiles_touched.sum()


def expand_pairs(
    prep: PreprocessOutput,
    *,
    grid_x: int,
    sort_order: GlobalSortOrder = GlobalSortOrder.Z_DEPTH,
    tile_based_culling: bool = False,
    campos=None,
    inverse_vp=None,
    image_width: int = 0,
    image_height: int = 0,
    tile_x: int = TILE_X,
    tile_y: int = TILE_Y,
):
    """The "Duplicate" stage: one (tile, depth, Gaussian) triple per pair.

    Returns (tile_id [N] int32, depth [N] float32, gauss_id [N] int32),
    unsorted, Gaussian-major. With ``tile_based_culling`` a pair is kept
    only where the Gaussian's least power over the tile's pixel rect is at
    most its ``opacity_power_threshold``. ``depth`` is the sort key: the
    Gaussian's depth, or the pair's per-tile depth for PTD_CENTER /
    PTD_MAX, which need ``campos`` [3], ``inverse_vp`` [4, 4] and the image
    size (ValueError without them). ``grid_x``, ``tile_x`` and ``tile_y``
    are those of the binning grid ``prep`` was made for.
    """
    with span("duplicate"):
        order = GlobalSortOrder(sort_order)
        per_tile = order in PER_TILE_ORDERS
        if per_tile and (campos is None or inverse_vp is None
                         or image_width <= 0 or image_height <= 0):
            raise ValueError(
                f"sort order {order.name} needs campos, inverse_vp, "
                "image_width and image_height"
            )
        dev = prep.tiles_touched.device
        touched = prep.tiles_touched.to(torch.int64)
        num_rendered = int(touched.sum())  # the reference's one D2H read
        P = touched.shape[0]
        g = torch.repeat_interleave(
            torch.arange(P, device=dev), touched, output_size=num_rendered
        )
        base = torch.cumsum(touched, 0) - touched
        local = torch.arange(num_rendered, device=dev) - base[g]
        rect_min = prep.rect_min.to(torch.int64)[g]
        width = (prep.rect_max[:, 0] - prep.rect_min[:, 0]).to(torch.int64)[g]
        ty = rect_min[:, 1] + local // width
        tx = rect_min[:, 0] + local % width
        # Culling and sort keys are discrete decisions: no gradient flows
        # through them.
        if tile_based_culling or order == GlobalSortOrder.PTD_MAX:
            tile_min, tile_max = tile_rect_bounds(tx, ty, tile_x, tile_y)
            power, max_pos = max_contrib_power_rect(
                prep.conic_opacity.detach()[g], prep.mean2d.detach()[g],
                tile_min, tile_max, patch_w=tile_x - 1, patch_h=tile_y - 1,
            )
        if tile_based_culling:
            keep = power <= prep.opacity_power_threshold.detach()[g]
            g, tx, ty = g[keep], tx[keep], ty[keep]
            if order == GlobalSortOrder.PTD_MAX:
                max_pos = max_pos[keep]
        tile_id = (ty * grid_x + tx).to(torch.int32)
        if not per_tile:
            return tile_id, prep.depth.detach()[g], g.to(torch.int32)
        if order == GlobalSortOrder.PTD_CENTER:
            # Center of the inclusive pixel rect, (tx*16 + 7.5, ty*16 + 7.5)
            # at 16x16.
            target = torch.stack(
                [tx.to(torch.float32) * tile_x + (tile_x - 1) / 2.0,
                 ty.to(torch.float32) * tile_y + (tile_y - 1) / 2.0], dim=-1)
        else:
            target = max_pos
        depth = per_tile_depth(target, prep.cov3d_inv9.detach()[g],
                               campos.detach(), image_width, image_height,
                               inverse_vp.detach())
        return tile_id, depth, g.to(torch.int32)


def sort_expanded(tile_id, depth, gauss_id, num_tiles: int,
                  num_gaussians: int) -> PairBuffer:
    """The "Sort" stage: stable (tile, depth) sort + per-tile ranges, and
    the Gaussian-major run offsets of the unsorted stream."""
    with span("sort"):
        s_tile, s_depth, s_gid, order = sort_pairs(tile_id, depth, gauss_id)
        starts, ends = identify_tile_ranges(s_tile, num_tiles)
        # The stream is Gaussian-major, so Gaussian g's run starts where
        # the first id >= g sits. A search, unlike torch.bincount (which
        # reads the ids' min and max back on CUDA), leaves the pair count
        # the frame's only read to the host.
        gauss_offsets = torch.searchsorted(
            gauss_id, torch.arange(num_gaussians + 1, dtype=gauss_id.dtype,
                                   device=gauss_id.device))
        return PairBuffer(
            tile_id=s_tile,
            depth=s_depth,
            gauss_id=s_gid,
            starts=starts,
            ends=ends,
            num_rendered=int(s_tile.shape[0]),
            orig_slot=order,
            gauss_offsets=gauss_offsets,
        )


def build_pairs(
    prep: PreprocessOutput,
    *,
    grid_x: int,
    grid_y: int,
    sort_order: GlobalSortOrder = GlobalSortOrder.Z_DEPTH,
    tile_based_culling: bool = False,
    campos=None,
    inverse_vp=None,
    image_width: int = 0,
    image_height: int = 0,
    tile_x: int = TILE_X,
    tile_y: int = TILE_Y,
) -> PairBuffer:
    """Expand, optionally tile-cull, key and sort all Gaussian/tile pairs
    of the binning grid (``grid_x`` x ``grid_y`` tiles of ``tile_x`` x
    ``tile_y`` pixels).

    The camera and image size are needed by the per-tile-depth orders only
    (see ``expand_pairs``). On the kernels' path (module notes) the
    expansion is ``stp/duplicate`` and the sort and ranges ``stp/sort``,
    as on the torch path."""
    if takes_kernel(prep.tiles_touched.device, sort_order, tile_based_culling):
        with span("duplicate"):
            keyed = duplicate_with_keys(prep.tiles_touched, prep.rect_min,
                                        prep.rect_max, prep.depth,
                                        grid_x=grid_x)
        with span("sort"):
            tile_id, depth, gauss_id, starts, ends, orig_slot = (
                sort_and_identify(keyed, prep.depth,
                                  num_tiles=grid_x * grid_y))
        return PairBuffer(tile_id=tile_id, depth=depth, gauss_id=gauss_id,
                          starts=starts, ends=ends,
                          num_rendered=int(keyed.keys.shape[0]),
                          orig_slot=orig_slot, gauss_offsets=keyed.offsets)
    expanded = expand_pairs(prep, grid_x=grid_x, sort_order=sort_order,
                            tile_based_culling=tile_based_culling,
                            campos=campos, inverse_vp=inverse_vp,
                            image_width=image_width, image_height=image_height,
                            tile_x=tile_x, tile_y=tile_y)
    return sort_expanded(*expanded, num_tiles=grid_x * grid_y,
                         num_gaussians=prep.tiles_touched.shape[0])
