"""Tiled rendering pipeline: preprocess -> duplicate -> sort -> blend (torch).

Port of ``stopthepop_tpu/render/pipeline.py::render_tiled`` (GLOBAL sort mode),
``render_tiled_kbuffer`` (PER_PIXEL_KBUFFER), ``render_tiled_hier``
(HIERARCHICAL), ``render_tiled_full`` (PER_PIXEL_FULL, forward only) and
``render_tiled_timed`` (GLOBAL, each stage timed by its span), the analog of
Rasterizer::forward, rasterizer_impl.cu:221-413:

  stage          reference                         here
  -------------  --------------------------------  ---------------------------
  preprocess     preprocessCUDA (1 thread/gauss)   torch ops (render/preprocess)
  scan+alloc     CUB InclusiveSum + D2H resize     the same, or cumsum + one D2H
                                                   read
  duplicate      duplicateWithKeys                 the same (kernels/pairs), or
                                                   repeat_interleave expansion
  sort           CUB DeviceRadixSort (64-bit key)  the same, or torch.sort on
                                                   the same key
  ranges         identifyTileRanges kernel         one pass over the sorted
                                                   keys, or searchsorted
  render         renderCUDA                        kernel K1 (kernels/global_blend)
                 renderkBufferCUDA                 kernel K3 (kernels/kbuffer_blend)
                 hierarchical renderer             kernel K5 (kernels/hier_blend)
                 renderSortedFullCUDA              kernel K7 (kernels/full_blend)
  render bwd     renderCUDA backward (atomicAdd)   kernel K2 + a deterministic
                                                   per-Gaussian segmented sum
                                                   (kernels/blend_vjp)
                 renderkBufferBackwardCUDA         kernel K4 + the same sum
                 hierarchical renderer backward    kernel K6 + the same sum

The kernels of the pairs (``kernels/pairs.py``) run on CUDA tensors in
Z_DEPTH and DISTANCE without tile-based culling; the torch ops elsewhere
(``render/duplicate.py::build_pairs``), with the same bits.

With any per-Gaussian row requiring grad (and grad mode on) the blend goes
through ``BlendGlobal`` / ``BlendKBuffer`` / ``BlendHier``; otherwise K1 /
K3 / K5 is called directly.

The binning tile (``tile_x`` x ``tile_y``, 16x16 by default, as the
reference) sets the pairs: preprocess, expansion and sort work on its grid.
The kernels blend tiles of at most 16x16 pixels: each binning tile is cut,
from its own origin, into ceil(tile_x / 16) x ceil(tile_y / 16) pieces, the
last column and row tile_x mod 16 and tile_y mod 16 wide, and each piece on
the image reads its parent's whole segment (``split_binning_segments``, as
the JAX package's resort modes do) and writes its gradients into the plane
of its index in the parent; the kernels' footprint tests drop most of the
pairs that cannot reach a warp before they are evaluated. Where both sides
are multiples of 16 the pieces are the image's 16x16 grid. With
tight-opacity bounding a pair's rect bounds its alpha >= 1/255 extent, so
the pairs of the parent's segment that miss a piece never pass the alpha
threshold there: every pixel blends what it blends at 16x16. Without it the
rect is 3 sigma wide and a pair may still pass the threshold just outside
it, where a larger bin keeps it: the JAX package's semantics at that bin.
GLOBAL takes any binning tile, as the JAX package's GLOBAL kernels do; the
resort modes take 16x16 and 32x16, as in the JAX package.
"""

from __future__ import annotations

import torch

from ..config import GlobalSortOrder
from ..constants import TILE_X, TILE_Y
from ..kernels.blend_vjp import BlendGlobal, BlendHier, BlendKBuffer, BlendSegments
from ..kernels.full_blend import blend_full_forward
from ..kernels.global_blend import binning_pieces, blend_global_forward
from ..kernels.hier_blend import blend_hier_forward
from ..kernels.kbuffer_blend import blend_kbuffer_forward
from .duplicate import build_pairs
from ..utils.profiling import span
from .preprocess import PreprocessOutput


def tile_grid(width: int, height: int, tile_x: int = TILE_X,
              tile_y: int = TILE_Y):
    return (width + tile_x - 1) // tile_x, (height + tile_y - 1) // tile_y


def global_subdivision(tile_x: int, tile_y: int):
    """(sx, sy): the pieces of at most 16x16 pixels a GLOBAL binning tile is
    cut into along x and y. ValueError unless both sides are positive."""
    if tile_x < 1 or tile_y < 1:
        raise ValueError(f"GLOBAL binning tile {tile_x}x{tile_y}: both "
                         "sides must be positive")
    return -(-tile_x // TILE_X), -(-tile_y // TILE_Y)


def resort_subdivision(tile_x: int, tile_y: int):
    """(sx, sy) of a resort-mode (PER_PIXEL_KBUFFER, HIERARCHICAL,
    PER_PIXEL_FULL) binning tile: 16x16 (reference parity) or 32x16, the
    sizes the JAX package's ``_resolve_bin_tile`` accepts; any other raises
    NotImplementedError."""
    if (tile_x, tile_y) == (TILE_X, TILE_Y):
        return 1, 1
    if (tile_x, tile_y) == (2 * TILE_X, TILE_Y):
        return 2, 1
    raise NotImplementedError(
        f"resort-mode binning tile {tile_x}x{tile_y}: the resort modes "
        "support 16x16 (reference parity) and 32x16 only")


def split_binning_segments(starts, ends, width: int, height: int,
                           tile_x: int, tile_y: int) -> BlendSegments:
    """Map the segments of ``tile_x`` x ``tile_y`` binning tiles to their
    blend tiles, the pieces of at most 16x16 pixels of a ``width`` x
    ``height`` image (``kernels/global_blend.py::binning_pieces``): each
    reads its parent's range and writes its gradients into the plane of
    its index in the parent. The planes of a parent's missing pieces are
    written by no tile; 16x16 bins need no plane map."""
    sx, sy = global_subdivision(tile_x, tile_y)
    parent, plane, pieces = binning_pieces(width, height, tile_x, tile_y,
                                           starts.device)
    return BlendSegments(starts[parent].contiguous(),
                         ends[parent].contiguous(),
                         None if (tile_x, tile_y) == (TILE_X, TILE_Y)
                         else plane, sx * sy, pieces)


def _binned_pairs(prep, tile_x, tile_y, *, image_width, image_height,
                  sort_order, tile_based_culling, campos, inverse_vp):
    """Build the pairs on the binning grid of ``tile_x`` x ``tile_y`` and
    split them over the blend tiles: (pairs, segs, the image's 16x16
    grid)."""
    with span("pairs"):
        bin_gx, bin_gy = tile_grid(image_width, image_height, tile_x, tile_y)
        pairs = build_pairs(prep, grid_x=bin_gx, grid_y=bin_gy,
                            sort_order=sort_order,
                            tile_based_culling=tile_based_culling,
                            campos=campos, inverse_vp=inverse_vp,
                            image_width=image_width,
                            image_height=image_height, tile_x=tile_x,
                            tile_y=tile_y)
        segs = split_binning_segments(pairs.starts, pairs.ends, image_width,
                                      image_height, tile_x, tile_y)
        return pairs, segs, tile_grid(image_width, image_height)


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
    tile_x: int = TILE_X,
    tile_y: int = TILE_Y,
):
    """GLOBAL-mode tiled render.

    Returns (color [3, H, W], final_T [H, W], n_contrib [H, W], pairs,
    depth_acc [H, W]), as the JAX package's ``render_tiled`` does. The
    per-tile-depth orders need ``campos`` and ``inverse_vp``. ``snapshot``,
    the (host arrays, settings) of a ``debug=True`` render, goes to the
    blend Function, whose backward dumps it on failure. ``tile_x`` x
    ``tile_y`` is the binning tile (``prep`` must be made for it): any
    positive size; ``pairs`` is on its grid.
    """
    global_subdivision(tile_x, tile_y)
    pairs, segs, (grid_x, grid_y) = _binned_pairs(
        prep, tile_x, tile_y, image_width=image_width,
        image_height=image_height, sort_order=sort_order,
        tile_based_culling=tile_based_culling, campos=campos,
        inverse_vp=inverse_vp)
    with span("blend"):
        rows = _rows(prep)
        depth = prep.depth.detach().contiguous()
        kw = dict(grid_x=grid_x, grid_y=grid_y, width=image_width,
                  height=image_height)
        if _needs_grad(rows):
            color, final_t, n_contrib, depth_acc = BlendGlobal.apply(
                *rows, depth, pairs, grid_x, grid_y, image_width,
                image_height, snapshot, segs)
        else:
            color, final_t, n_contrib, depth_acc = blend_global_forward(
                pairs.gauss_id, segs.starts, segs.ends, *rows, depth, **kw,
                pieces=segs.pieces)
        # Background composite outside the kernel, as in the JAX package:
        # autograd gives d_bg and folds the background into the final_T
        # cotangent.
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
    tile_x: int = TILE_X,
    tile_y: int = TILE_Y,
):
    """PER_PIXEL_KBUFFER tiled render: every pixel resorts its tile's
    stream through a window of ``k`` entries by exact per-ray depth (kernel
    K3; its backward K4).

    Returns (color [3, H, W], final_T [H, W], n_contrib [H, W] (commits),
    pairs, depth_acc [H, W]), as the JAX package's ``render_tiled_kbuffer``
    does. ``snapshot`` as in ``render_tiled``; binning tile 16x16 or 32x16.
    """
    resort_subdivision(tile_x, tile_y)
    pairs, segs, (grid_x, grid_y) = _binned_pairs(
        prep, tile_x, tile_y, image_width=image_width,
        image_height=image_height, sort_order=sort_order,
        tile_based_culling=tile_based_culling, campos=campos,
        inverse_vp=inverse_vp)
    with span("blend"):
        rows = _rows(prep)
        cam = (prep.cov3d_inv9.detach().contiguous(),
               inverse_vp.detach().contiguous(), campos.detach().contiguous())
        if _needs_grad(rows):
            color, final_t, n_contrib, depth_acc = BlendKBuffer.apply(
                *rows, *cam, pairs, k, grid_x, grid_y, image_width,
                image_height, snapshot, segs)
        else:
            color, final_t, n_contrib, depth_acc = blend_kbuffer_forward(
                pairs.gauss_id, segs.starts, segs.ends, *rows, *cam, k=k,
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
    batched_cascade: bool = False,
    snapshot=None,
    tile_x: int = TILE_X,
    tile_y: int = TILE_Y,
):
    """HIERARCHICAL tiled render: every 16x16 tile's stream cascades
    through the tail (4x4 sub-tile), mid (2x2 quad) and head (pixel)
    windows of ``queue_sizes`` = (tile_4x4, tile_2x2, per_pixel) entries, and
    a head pop blends (kernel K5; its backward K6). ``batched_cascade``
    moves the entries through the mid and head windows in sorted
    sub-batches of 8 (``kernels/hier_blend.py``).

    Returns (color [3, H, W], final_T [H, W], n_contrib [H, W] (commits with
    alpha > 0), pairs, depth_acc [H, W]), as the JAX package's
    ``render_tiled_hier`` does. ``snapshot`` as in ``render_tiled``; binning
    tile 16x16 or 32x16.
    """
    resort_subdivision(tile_x, tile_y)
    pairs, segs, (grid_x, grid_y) = _binned_pairs(
        prep, tile_x, tile_y, image_width=image_width,
        image_height=image_height, sort_order=sort_order,
        tile_based_culling=tile_based_culling, campos=campos,
        inverse_vp=inverse_vp)
    with span("blend"):
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
                image_width, image_height, snapshot, segs, batched_cascade)
        else:
            color, final_t, n_contrib, depth_acc = blend_hier_forward(
                pairs.gauss_id, segs.starts, segs.ends, *rows, *cam,
                queue_sizes=queues, hier_4x4_culling=hier_4x4_culling,
                grid_x=grid_x, grid_y=grid_y, width=image_width,
                height=image_height, batched_cascade=batched_cascade)
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
    tile_x: int = TILE_X,
    tile_y: int = TILE_Y,
):
    """PER_PIXEL_FULL tiled render: every pixel sorts its 16x16 tile's
    whole stream by exact per-ray depth and blends it (kernel K7). Forward
    only, like the reference's renderSortedFullCUDA: the inputs are
    detached. There is no segment cap. Binning tile 16x16 or 32x16.

    Returns (color [3, H, W], final_T [H, W], n_contrib [H, W] (commits),
    pairs, depth_acc [H, W]), as the JAX package's ``render_tiled_full``
    does.
    """
    resort_subdivision(tile_x, tile_y)
    pairs, segs, (grid_x, grid_y) = _binned_pairs(
        prep, tile_x, tile_y, image_width=image_width,
        image_height=image_height, sort_order=sort_order,
        tile_based_culling=tile_based_culling, campos=campos,
        inverse_vp=inverse_vp)
    with span("blend"):
        rows = [r.detach() for r in _rows(prep)]
        color, final_t, n_contrib, depth_acc = blend_full_forward(
            pairs.gauss_id, segs.starts, segs.ends, *rows,
            prep.cov3d_inv9.detach().contiguous(),
            inverse_vp.detach().contiguous(), campos.detach().contiguous(),
            grid_x=grid_x, grid_y=grid_y, width=image_width,
            height=image_height)
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
    JAX package's ``render_tiled_timed``: ``prep_fn()`` runs in the span
    ``stp/preprocess`` and ``render_tiled`` renders with ``timer``
    listening (``utils/profiling.StageTimer.listening``), which times each
    stage's span with the device synchronized around it; the Render stage
    is the blend and the background composite. The pipeline is
    ``render_tiled``'s, on 16x16 tiles; any sort mode is timed the same way
    by rendering inside ``timer.listening()``.

    ``prep_fn`` is a zero-argument callable producing the PreprocessOutput.
    Returns what ``render_tiled`` returns.
    """
    with timer.listening():
        with span("preprocess"):
            prep = prep_fn()
        out = render_tiled(prep, bg, image_width=image_width,
                           image_height=image_height, sort_order=sort_order,
                           tile_based_culling=tile_based_culling,
                           campos=campos, inverse_vp=inverse_vp)
    timer.frame()
    return out
