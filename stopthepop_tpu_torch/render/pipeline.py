"""Tiled rendering pipeline: preprocess -> duplicate -> sort -> blend (torch).

Port of ``stopthepop_tpu/render/pipeline.py::render_tiled`` (GLOBAL sort mode),
``render_tiled_kbuffer`` (PER_PIXEL_KBUFFER, 16x16 binning),
``render_tiled_hier`` (HIERARCHICAL, 16x16 binning), ``render_tiled_full``
(PER_PIXEL_FULL, 16x16 binning, forward only) and ``render_tiled_timed``
(GLOBAL, each stage timed on its own), the analog of
Rasterizer::forward, rasterizer_impl.cu:221-413:

  stage          reference                         here
  -------------  --------------------------------  ---------------------------
  preprocess     preprocessCUDA (1 thread/gauss)   torch ops (render/preprocess)
  scan+alloc     CUB InclusiveSum + D2H resize     cumsum + one D2H read
  duplicate      duplicateWithKeys                 repeat_interleave expansion
  sort           CUB DeviceRadixSort (64-bit key)  torch.sort on the same key
  ranges         identifyTileRanges kernel         searchsorted
  render         renderCUDA                        kernel K1 (kernels/global_blend)
                 renderkBufferCUDA                 kernel K3 (kernels/kbuffer_blend)
                 hierarchical renderer             kernel K5 (kernels/hier_blend)
                 renderSortedFullCUDA              kernel K7 (kernels/full_blend)
  render bwd     renderCUDA backward (atomicAdd)   kernel K2 + a deterministic
                                                   per-Gaussian segmented sum
                                                   (kernels/blend_vjp)
                 renderkBufferBackwardCUDA         kernel K4 + the same sum
                 hierarchical renderer backward    kernel K6 + the same sum

With any per-Gaussian row requiring grad (and grad mode on) the blend goes
through ``BlendGlobal`` / ``BlendKBuffer`` / ``BlendHier``; otherwise K1 /
K3 / K5 is called directly.
"""

from __future__ import annotations

import torch

from ..config import GlobalSortOrder
from ..constants import TILE_X, TILE_Y
from ..kernels.blend_vjp import BlendGlobal, BlendHier, BlendKBuffer
from ..kernels.full_blend import blend_full_forward
from ..kernels.global_blend import blend_global_forward
from ..kernels.hier_blend import blend_hier_forward
from ..kernels.kbuffer_blend import blend_kbuffer_forward
from .duplicate import build_pairs, expand_pairs, sort_expanded
from .preprocess import PreprocessOutput


def tile_grid(width: int, height: int):
    return (width + TILE_X - 1) // TILE_X, (height + TILE_Y - 1) // TILE_Y


def _rows(prep: PreprocessOutput):
    return (prep.mean2d.contiguous(), prep.conic_opacity.contiguous(),
            prep.rgb.contiguous())


def _needs_grad(rows) -> bool:
    return torch.is_grad_enabled() and any(r.requires_grad for r in rows)


def render_tiled(
    prep: PreprocessOutput,
    bg,
    *,
    image_width: int,
    image_height: int,
    sort_order: GlobalSortOrder = GlobalSortOrder.Z_DEPTH,
    tile_based_culling: bool = False,
    campos=None,
    inverse_vp=None,
    snapshot=None,
):
    """GLOBAL-mode tiled render.

    Returns (color [3, H, W], final_T [H, W], n_contrib [H, W], pairs,
    depth_acc [H, W]), as the JAX package's ``render_tiled`` does. The
    per-tile-depth orders need ``campos`` and ``inverse_vp``. ``snapshot``,
    the (host arrays, settings) of a ``debug=True`` render, goes to the
    blend Function, whose backward dumps it on failure.
    """
    grid_x, grid_y = tile_grid(image_width, image_height)
    pairs = build_pairs(prep, grid_x=grid_x, grid_y=grid_y,
                        sort_order=sort_order,
                        tile_based_culling=tile_based_culling, campos=campos,
                        inverse_vp=inverse_vp, image_width=image_width,
                        image_height=image_height)
    rows = _rows(prep)
    depth = prep.depth.detach().contiguous()
    kw = dict(grid_x=grid_x, grid_y=grid_y, width=image_width,
              height=image_height)
    if _needs_grad(rows):
        color, final_t, n_contrib, depth_acc = BlendGlobal.apply(
            *rows, depth, pairs, grid_x, grid_y, image_width, image_height,
            snapshot)
    else:
        color, final_t, n_contrib, depth_acc = blend_global_forward(
            pairs.gauss_id, pairs.starts, pairs.ends, *rows, depth, **kw)
    # Background composite outside the kernel, as in the JAX package: autograd
    # gives d_bg and folds the background into the final_T cotangent.
    color = color + final_t[None, :, :] * bg[:, None, None]
    return color, final_t, n_contrib, pairs, depth_acc


def render_tiled_kbuffer(
    prep: PreprocessOutput,
    bg,
    *,
    image_width: int,
    image_height: int,
    campos,
    inverse_vp,
    k: int = 4,
    sort_order: GlobalSortOrder = GlobalSortOrder.Z_DEPTH,
    tile_based_culling: bool = False,
    snapshot=None,
):
    """PER_PIXEL_KBUFFER tiled render (16x16 binning tiles): every pixel
    resorts its tile's stream through a window of ``k`` entries by exact
    per-ray depth (kernel K3; its backward K4).

    Returns (color [3, H, W], final_T [H, W], n_contrib [H, W] (commits),
    pairs, depth_acc [H, W]), as the JAX package's ``render_tiled_kbuffer``
    does. ``snapshot`` as in ``render_tiled``.
    """
    grid_x, grid_y = tile_grid(image_width, image_height)
    pairs = build_pairs(prep, grid_x=grid_x, grid_y=grid_y,
                        sort_order=sort_order,
                        tile_based_culling=tile_based_culling, campos=campos,
                        inverse_vp=inverse_vp, image_width=image_width,
                        image_height=image_height)
    rows = _rows(prep)
    cam = (prep.cov3d_inv9.detach().contiguous(),
           inverse_vp.detach().contiguous(), campos.detach().contiguous())
    if _needs_grad(rows):
        color, final_t, n_contrib, depth_acc = BlendKBuffer.apply(
            *rows, *cam, pairs, k, grid_x, grid_y, image_width, image_height,
            snapshot)
    else:
        color, final_t, n_contrib, depth_acc = blend_kbuffer_forward(
            pairs.gauss_id, pairs.starts, pairs.ends, *rows, *cam, k=k,
            grid_x=grid_x, grid_y=grid_y, width=image_width,
            height=image_height)
    color = color + final_t[None, :, :] * bg[:, None, None]
    return color, final_t, n_contrib, pairs, depth_acc


def render_tiled_hier(
    prep: PreprocessOutput,
    bg,
    *,
    image_width: int,
    image_height: int,
    campos,
    inverse_vp,
    queue_sizes=(64, 8, 4),
    sort_order: GlobalSortOrder = GlobalSortOrder.Z_DEPTH,
    tile_based_culling: bool = False,
    hier_4x4_culling: bool = False,
    snapshot=None,
):
    """HIERARCHICAL tiled render (16x16 binning tiles): every tile's stream
    cascades through the tail (4x4 sub-tile), mid (2x2 quad) and head (pixel)
    windows of ``queue_sizes`` = (tile_4x4, tile_2x2, per_pixel) entries, and
    a head pop blends (kernel K5; its backward K6).

    Returns (color [3, H, W], final_T [H, W], n_contrib [H, W] (commits with
    alpha > 0), pairs, depth_acc [H, W]), as the JAX package's
    ``render_tiled_hier`` does. ``snapshot`` as in ``render_tiled``.
    """
    grid_x, grid_y = tile_grid(image_width, image_height)
    pairs = build_pairs(prep, grid_x=grid_x, grid_y=grid_y,
                        sort_order=sort_order,
                        tile_based_culling=tile_based_culling, campos=campos,
                        inverse_vp=inverse_vp, image_width=image_width,
                        image_height=image_height)
    rows = _rows(prep)
    # The depths, the culling thresholds and the camera only choose the
    # cascade's order and validity: no gradient flows into them.
    cam = (prep.cov3d_inv9.detach().contiguous(),
           prep.opacity_power_threshold.detach().contiguous(),
           inverse_vp.detach().contiguous(), campos.detach().contiguous())
    queues = tuple(queue_sizes)
    if _needs_grad(rows):
        color, final_t, n_contrib, depth_acc = BlendHier.apply(
            *rows, *cam, pairs, queues, hier_4x4_culling, grid_x, grid_y,
            image_width, image_height, snapshot)
    else:
        color, final_t, n_contrib, depth_acc = blend_hier_forward(
            pairs.gauss_id, pairs.starts, pairs.ends, *rows, *cam,
            queue_sizes=queues, hier_4x4_culling=hier_4x4_culling,
            grid_x=grid_x, grid_y=grid_y, width=image_width,
            height=image_height)
    color = color + final_t[None, :, :] * bg[:, None, None]
    return color, final_t, n_contrib, pairs, depth_acc


def render_tiled_full(
    prep: PreprocessOutput,
    bg,
    *,
    image_width: int,
    image_height: int,
    campos,
    inverse_vp,
    sort_order: GlobalSortOrder = GlobalSortOrder.Z_DEPTH,
    tile_based_culling: bool = False,
):
    """PER_PIXEL_FULL tiled render (16x16 binning tiles): every pixel sorts
    its tile's whole stream by exact per-ray depth and blends it (kernel K7).
    Forward only, like the reference's renderSortedFullCUDA: the inputs are
    detached. There is no segment cap.

    Returns (color [3, H, W], final_T [H, W], n_contrib [H, W] (commits),
    pairs, depth_acc [H, W]), as the JAX package's ``render_tiled_full``
    does.
    """
    grid_x, grid_y = tile_grid(image_width, image_height)
    pairs = build_pairs(prep, grid_x=grid_x, grid_y=grid_y,
                        sort_order=sort_order,
                        tile_based_culling=tile_based_culling, campos=campos,
                        inverse_vp=inverse_vp, image_width=image_width,
                        image_height=image_height)
    rows = [r.detach() for r in _rows(prep)]
    color, final_t, n_contrib, depth_acc = blend_full_forward(
        pairs.gauss_id, pairs.starts, pairs.ends, *rows,
        prep.cov3d_inv9.detach().contiguous(),
        inverse_vp.detach().contiguous(), campos.detach().contiguous(),
        grid_x=grid_x, grid_y=grid_y, width=image_width, height=image_height)
    color = color + final_t[None, :, :] * bg.detach()[:, None, None]
    return color, final_t, n_contrib, pairs, depth_acc


def render_tiled_timed(
    prep_fn,
    timer,
    bg,
    *,
    image_width: int,
    image_height: int,
    sort_order: GlobalSortOrder = GlobalSortOrder.Z_DEPTH,
    tile_based_culling: bool = False,
    campos=None,
    inverse_vp=None,
):
    """GLOBAL render with per-stage timing (the reference Timer's stages
    Preprocess / Duplicate / Sort / Render, rasterizer_impl.cu:248), as the
    JAX package's ``render_tiled_timed``: each stage runs on its own through
    ``timer.time`` (utils/profiling.StageTimer), which synchronizes the
    device around it; the Render stage is kernel K1 (its plain version on
    CPU tensors) and the background composite. The same function as
    ``render_tiled`` without gradients.

    ``prep_fn`` is a zero-argument callable producing the PreprocessOutput.
    Returns what ``render_tiled`` returns.
    """
    grid_x, grid_y = tile_grid(image_width, image_height)
    prep = timer.time("Preprocess", prep_fn)
    expanded = timer.time(
        "Duplicate", expand_pairs, prep, grid_x=grid_x,
        sort_order=sort_order, tile_based_culling=tile_based_culling,
        campos=campos, inverse_vp=inverse_vp, image_width=image_width,
        image_height=image_height)
    pairs = timer.time("Sort", sort_expanded, *expanded,
                       num_tiles=grid_x * grid_y,
                       num_gaussians=prep.tiles_touched.shape[0])

    def render():
        color, final_t, n_contrib, depth_acc = blend_global_forward(
            pairs.gauss_id, pairs.starts, pairs.ends, *_rows(prep),
            prep.depth.detach().contiguous(), grid_x=grid_x, grid_y=grid_y,
            width=image_width, height=image_height)
        color = color + final_t[None, :, :] * bg[:, None, None]
        return color, final_t, n_contrib, depth_acc

    color, final_t, n_contrib, depth_acc = timer.time("Render", render)
    timer.frame()
    return color, final_t, n_contrib, pairs, depth_acc
