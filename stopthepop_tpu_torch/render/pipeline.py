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

The four modes share one body, ``render_sorted``; what differs between them
(the binning tiles taken, the kernels, the autograd Function, the camera
tensors) is declared in ``_MODES``. ``sort_mode_of`` reads a mode and its
options from the raster settings.

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

from typing import Callable, NamedTuple, Optional

import torch

from ..config import GlobalSortOrder, SortMode
from ..constants import TILE_X, TILE_Y
from ..kernels import full_blend
from ..kernels.blend_vjp import (
    BlendGlobal,
    BlendHier,
    BlendKBuffer,
    BlendSegments,
    Kernels,
)
from ..kernels.global_blend import binning_pieces
from ..kernels.hier_blend import check_hier_queues
from ..kernels.kbuffer_blend import check_window
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


class _TiledMode(NamedTuple):
    """What differs between the sort modes' tiled renders: the one body,
    ``render_sorted``, reads it."""
    subdivision: Callable   # checks the binning tile; raises where refused
    kernels: Kernels        # the forward wrapper, on its kernel module
    function: Optional[type]  # the differentiable blend; None: forward only
    # The detached tensors the kernels take after the rows, by name: fields
    # of PreprocessOutput, "inverse_vp" and "campos".
    camera: tuple
    pieces: bool = False    # the forward wrapper takes the piece table


_RESORT_CAMERA = ("cov3d_inv9", "inverse_vp", "campos")
_MODES = {
    SortMode.GLOBAL: _TiledMode(global_subdivision, BlendGlobal.kernels,
                                BlendGlobal, ("depth",), pieces=True),
    SortMode.PPX_KBUFFER: _TiledMode(resort_subdivision, BlendKBuffer.kernels,
                                     BlendKBuffer, _RESORT_CAMERA),
    # The depths, the culling thresholds and the camera only choose the
    # cascade's order and validity: no gradient flows into them.
    SortMode.HIER: _TiledMode(
        resort_subdivision, BlendHier.kernels, BlendHier,
        ("cov3d_inv9", "opacity_power_threshold", "inverse_vp", "campos")),
    # Forward only, like the reference's renderSortedFullCUDA.
    SortMode.PPX_FULL: _TiledMode(
        resort_subdivision, Kernels(full_blend, "blend_full_forward"), None,
        _RESORT_CAMERA),
}


def sort_mode_of(rs, tile_shape=None, batched_cascade: bool = False):
    """(sort mode, ``render_sorted``'s keywords) of the raster settings
    ``rs`` and the binning tile ``tile_shape`` (None: 16x16). The mode's
    options: ``k`` for PPX_KBUFFER; ``queue_sizes``, ``hier_4x4_culling``
    and ``batched_cascade`` for HIER. Raises where the queues or the tile
    are out of the mode's range, or per-ray depths lack
    ``inv_viewprojmatrix``."""
    ext = rs.settings
    mode = SortMode(ext.sort_settings.sort_mode)
    order = GlobalSortOrder(ext.sort_settings.sort_order)
    sizes = ext.sort_settings.queue_sizes
    options = {}
    if mode == SortMode.PPX_KBUFFER:
        options = {"k": check_window(sizes.per_pixel)}
    elif mode == SortMode.HIER:
        options = {"queue_sizes": check_hier_queues(
                       sizes.tile_4x4, sizes.tile_2x2, sizes.per_pixel),
                   "hier_4x4_culling":
                       ext.culling_settings.hierarchical_4x4_culling,
                   "batched_cascade": batched_cascade}
    per_ray = mode != SortMode.GLOBAL or order in (
        GlobalSortOrder.PTD_CENTER, GlobalSortOrder.PTD_MAX)
    if per_ray and rs.inv_viewprojmatrix is None:
        raise ValueError(
            f"{mode.name} with {order.name} needs inv_viewprojmatrix in the "
            "raster settings (per-ray depths)")
    tile_x, tile_y = (TILE_X, TILE_Y) if tile_shape is None else (
        int(v) for v in tile_shape)
    _MODES[mode].subdivision(tile_x, tile_y)
    return mode, dict(
        sort_order=order,
        tile_based_culling=ext.culling_settings.tile_based_culling,
        tile_x=tile_x, tile_y=tile_y, **options)


def render_sorted(mode: SortMode, prep: PreprocessOutput, bg, *,
                  image_width: int, image_height: int, campos, inverse_vp,
                  sort_order: GlobalSortOrder, tile_based_culling: bool,
                  tile_x: int, tile_y: int, snapshot=None, **options):
    """The tiled render of the sort mode ``mode``; ``options`` are its
    kernels' keywords (``sort_mode_of``).

    Returns (color [3, H, W], final_T [H, W], n_contrib [H, W], pairs,
    depth_acc [H, W]), as the JAX package's tiled renders do. The resort
    modes and the per-tile-depth orders need ``campos`` and
    ``inverse_vp``. ``snapshot``, the (host arrays, settings) of a
    ``debug=True`` render, goes to the blend Function, whose backward dumps
    it on failure. ``tile_x`` x ``tile_y`` is the binning tile (``prep``
    must be made for it; the mode's ``subdivision`` says which it takes);
    ``pairs`` is on its grid. The blend runs through the mode's Function
    when a per-Gaussian row requires grad (and grad mode is on), else
    straight through its forward wrapper.
    """
    spec = _MODES[mode]
    spec.subdivision(tile_x, tile_y)
    pairs, segs, (grid_x, grid_y) = _binned_pairs(
        prep, tile_x, tile_y, image_width=image_width,
        image_height=image_height, sort_order=sort_order,
        tile_based_culling=tile_based_culling, campos=campos,
        inverse_vp=inverse_vp)
    with span("blend"):
        rows = (prep.mean2d.contiguous(), prep.conic_opacity.contiguous(),
                prep.rgb.contiguous())
        sources = {**prep._asdict(), "inverse_vp": inverse_vp,
                   "campos": campos}
        cam = tuple(sources[n].detach().contiguous() for n in spec.camera)
        kw = dict(grid_x=grid_x, grid_y=grid_y, width=image_width,
                  height=image_height, **options)
        if spec.function is not None and torch.is_grad_enabled() and any(
                r.requires_grad for r in rows):
            color, final_t, n_contrib, depth_acc = spec.function.apply_named(
                *rows, *cam, pairs, snapshot=snapshot, segs=segs, **kw)
        else:
            if spec.function is None:  # forward only: no gradient anywhere
                rows, bg = [r.detach() for r in rows], bg.detach()
            if spec.pieces:
                kw["pieces"] = segs.pieces
            forward = getattr(spec.kernels.module, spec.kernels.forward)
            color, final_t, n_contrib, depth_acc = forward(
                pairs.gauss_id, segs.starts, segs.ends, *rows, *cam, **kw)
        # Background composite outside the kernel, as in the JAX package:
        # autograd gives d_bg and folds the background into the final_T
        # cotangent.
        color = color + final_t[None, :, :] * bg[:, None, None]
    return color, final_t, n_contrib, pairs, depth_acc


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
    """GLOBAL-mode tiled render (``render_sorted``), as the JAX package's
    ``render_tiled``: any positive binning tile."""
    return render_sorted(
        SortMode.GLOBAL, prep, bg, image_width=image_width,
        image_height=image_height, campos=campos, inverse_vp=inverse_vp,
        sort_order=sort_order, tile_based_culling=tile_based_culling,
        tile_x=tile_x, tile_y=tile_y, snapshot=snapshot)


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
    """PER_PIXEL_KBUFFER tiled render (``render_sorted``), as the JAX
    package's ``render_tiled_kbuffer``: every pixel resorts its tile's
    stream through a window of ``k`` entries by exact per-ray depth (kernel
    K3; its backward K4). n_contrib counts commits; binning tile 16x16 or
    32x16.
    """
    return render_sorted(
        SortMode.PPX_KBUFFER, prep, bg, image_width=image_width,
        image_height=image_height, campos=campos, inverse_vp=inverse_vp,
        sort_order=sort_order, tile_based_culling=tile_based_culling,
        tile_x=tile_x, tile_y=tile_y, snapshot=snapshot, k=k)


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
    """HIERARCHICAL tiled render (``render_sorted``), as the JAX package's
    ``render_tiled_hier``: every 16x16 tile's stream cascades through the
    tail (4x4 sub-tile), mid (2x2 quad) and head (pixel) windows of
    ``queue_sizes`` = (tile_4x4, tile_2x2, per_pixel) entries, and a head
    pop blends (kernel K5; its backward K6). ``batched_cascade`` moves the
    entries through the mid and head windows in sorted sub-batches of 8
    (``kernels/hier_blend.py``). n_contrib counts commits with alpha > 0;
    binning tile 16x16 or 32x16.
    """
    return render_sorted(
        SortMode.HIER, prep, bg, image_width=image_width,
        image_height=image_height, campos=campos, inverse_vp=inverse_vp,
        sort_order=sort_order, tile_based_culling=tile_based_culling,
        tile_x=tile_x, tile_y=tile_y, snapshot=snapshot,
        queue_sizes=tuple(queue_sizes), hier_4x4_culling=hier_4x4_culling,
        batched_cascade=batched_cascade)


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
    """PER_PIXEL_FULL tiled render (``render_sorted``), as the JAX
    package's ``render_tiled_full``: every pixel sorts its 16x16 tile's
    whole stream by exact per-ray depth and blends it (kernel K7). Forward
    only, like the reference's renderSortedFullCUDA: the inputs are
    detached. There is no segment cap. n_contrib counts commits; binning
    tile 16x16 or 32x16.
    """
    return render_sorted(
        SortMode.PPX_FULL, prep, bg, image_width=image_width,
        image_height=image_height, campos=campos, inverse_vp=inverse_vp,
        sort_order=sort_order, tile_based_culling=tile_based_culling,
        tile_x=tile_x, tile_y=tile_y)


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
