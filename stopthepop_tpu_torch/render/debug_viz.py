"""Debug visualization (torch).

Port of ``stopthepop_tpu/render/debug_viz.py``, the reference's
DebugVisualization pipeline (rasterizer_debug.h:11-56,
applyDebugVisualization rasterizer_impl.cu:54-109, colormap render
forward.cu:674-729): six scalar-field modes, min/max/mean/std statistics, an
optional data callback for GUI pixel probing, and a colormap rendering —
magma for counts, errors and transmittance, turbo for depth.

  * Depth, Transmittance and GaussianCountPerPixel read the blend kernels'
    own outputs (depth_acc, final_T, n_contrib: K1, K3, K5 and K7 write
    them); GaussianCountPerTile reads the per-tile pair counts of the
    sorted pair list.
  * The sort-error modes (the paper's popping measure,
    stopthepop_common.cuh:264-282) replay the GLOBAL blend order densely:
    per pixel, a running max of committed per-ray depths; the error is the
    opacity (or the depth gap) of what is blended at or below it. O(P x
    pixels), for small scenes only. The resort modes' maps in their own pop
    order come from their oracles (``render/naive.py``, ``sort_error=True``).
  * The colormap tables are data (``render/colormaps.py``), so no host
    needs matplotlib to colour.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from ..config import DebugVisualization, GlobalSortOrder
from ..constants import T_THRESHOLD, TILE_X, TILE_Y
from ..ops.stopthepop import depth_along_ray
from ..ops.transforms import compute_view_ray
from .colormaps import MAGMA_TABLE, TURBO_TABLE
from .naive import _alpha, _covers, _pixel_grid, _pixel_tiles, pair_stream_keys
from .preprocess import PreprocessOutput


def apply_colormap(x01, table):
    """x01 [H, W] in [0, 1] -> [3, H, W] colormapped image (the index
    truncates, as the JAX package's ``astype(int32)``)."""
    idx = torch.clamp((x01 * 255.0).to(torch.int32), 0, 255).long()
    return torch.as_tensor(table, device=x01.device)[idx].permute(2, 0, 1)


@dataclass
class DebugVisualizationData:
    """Mirror of the reference's DebugVisualizationData
    (rasterizer_debug.h:43-56)."""

    debug_pixel: Optional[tuple] = None   # (x, y) probe
    data_callback: Optional[Callable] = None
    minimum: float = 0.0
    maximum: float = 0.0
    mean: float = 0.0
    std: float = 0.0
    debug_pixel_value: float = 0.0
    timings_text: str = ""


def field_stats(field):
    """(min, max, mean, population std) of a scalar field, as 0-d tensors."""
    return field.min(), field.max(), field.mean(), field.std(correction=0)


def normalize_field(field, lo=None, hi=None):
    lo = field.min() if lo is None else lo
    hi = field.max() if hi is None else hi
    return (field - lo) / torch.clamp(hi - lo, min=1e-12)


def sort_error_maps(prep: PreprocessOutput, width: int, height: int, campos,
                    inverse_vp, sort_order=None, tile=(TILE_X, TILE_Y)):
    """(error_opacity [H, W], error_distance [H, W]) of a GLOBAL-mode order.

    Per pixel, contributions are replayed in the mode's stream order
    (``sort_order``: Z_DEPTH default, PTD_CENTER / PTD_MAX per-tile keys);
    a committed contribution whose per-ray depth is at or below the running
    maximum of earlier committed contributions adds its alpha (resp. the
    unweighted depth gap) to the pixel's error, the reference's rule
    (stopthepop_common.cuh:264-282).
    """
    if sort_order is None:
        sort_order = GlobalSortOrder.Z_DEPTH
    dev = prep.mean2d.device
    N = width * height
    pix = _pixel_grid(width, height, dev)
    pix_tile = _pixel_tiles(pix, tile)
    alpha, skip = _alpha(prep.conic_opacity, prep.mean2d, pix)
    drop = skip | ~_covers(prep, pix_tile)
    a_eff = torch.where(drop, torch.zeros_like(alpha), alpha)
    key = pair_stream_keys(prep, pix_tile, sort_order, campos, inverse_vp,
                           width, height, tile)
    key = torch.where(a_eff > 0.0, key, torch.full_like(a_eff, float("inf")))
    order = torch.sort(key, dim=0, stable=True).indices  # [P, N]
    a_eff = torch.gather(a_eff, 0, order)
    viewdir = compute_view_ray(pix, width, height, inverse_vp, campos)
    ray_d = torch.gather(
        depth_along_ray(prep.cov3d_inv9[:, None, :], viewdir[None, :, :]),
        0, order)

    # The committed mask by the masked-cumprod transmittance recurrence.
    U = torch.exp(torch.cumsum(torch.log1p(-a_eff), dim=0))
    commit = (U >= T_THRESHOLD) & (a_eff > 0.0)
    d_masked = torch.where(commit, ray_d,
                           torch.full_like(ray_d, -float("inf")))
    prior_max = torch.cat(
        [torch.full((1, N), -float("inf"), device=dev),
         torch.cummax(d_masked, dim=0).values[:-1]], dim=0)
    out_of_order = commit & (ray_d <= prior_max)
    err_op = torch.where(out_of_order, a_eff, 0.0).sum(dim=0)
    err_dist = torch.where(out_of_order, prior_max - ray_d, 0.0).sum(dim=0)
    return err_op.reshape(height, width), err_dist.reshape(height, width)


def tile_count_map(pair_counts, width: int, height: int,
                   tile=(TILE_X, TILE_Y)):
    """Per-pixel value = pair count of the pixel's binning tile of ``tile``
    = (tile_x, tile_y) pixels. [H, W] float32."""
    tile_x, tile_y = tile
    grid_x = (width + tile_x - 1) // tile_x
    grid_y = (height + tile_y - 1) // tile_y
    per_tile = pair_counts.reshape(grid_y, grid_x).to(torch.float32)
    full = per_tile.repeat_interleave(tile_y, dim=0).repeat_interleave(
        tile_x, dim=1)
    return full[:height, :width]


def debug_field(mode: DebugVisualization, *, final_t, n_contrib,
                depth_acc=None, pair_counts=None, prep=None, campos=None,
                inverse_vp=None, width: int = 0, height: int = 0,
                tile=(TILE_X, TILE_Y)):
    """The scalar field [H, W] of a debug mode, and its colormap table.
    ``tile`` is the binning tile ``prep`` was made for, and
    ``pair_counts`` are its tiles' (row-major)."""
    mode = DebugVisualization(mode)
    if mode == DebugVisualization.Depth:
        # Expected depth of the blended mass (turbo, like the reference).
        return depth_acc / torch.clamp(1.0 - final_t, min=1e-6), TURBO_TABLE
    if mode == DebugVisualization.Transmittance:
        return final_t, MAGMA_TABLE
    if mode == DebugVisualization.GaussianCountPerPixel:
        return n_contrib.to(torch.float32), MAGMA_TABLE
    if mode == DebugVisualization.GaussianCountPerTile:
        return tile_count_map(pair_counts, width, height, tile), MAGMA_TABLE
    if mode in (DebugVisualization.SortErrorOpacity,
                DebugVisualization.SortErrorDistance):
        err_op, err_dist = sort_error_maps(prep, width, height, campos,
                                           inverse_vp, tile=tile)
        return (err_op if mode == DebugVisualization.SortErrorOpacity
                else err_dist), MAGMA_TABLE
    raise ValueError(f"not a renderable debug mode: {mode}")


def apply_debug_visualization(mode: DebugVisualization, *, final_t, n_contrib,
                              depth_acc=None, pair_counts=None, prep=None,
                              campos=None, inverse_vp=None, width: int = 0,
                              height: int = 0,
                              data: Optional[DebugVisualizationData] = None,
                              tile=(TILE_X, TILE_Y)):
    """Scalar field -> stats -> colormapped [3, H, W] image.

    The reference's applyDebugVisualization post-pass
    (rasterizer_impl.cu:54-109): compute the per-pixel scalar field for
    ``mode`` (``debug_field``), record min/max/mean/std and the probe
    pixel's value into ``data``, invoke its callback (as the JAX package
    does, after the probe is read), and return the colormap rendering. The
    sort-error modes use the GLOBAL Z_DEPTH order whatever the sort mode,
    as in the JAX package.
    """
    field, table = debug_field(
        mode, final_t=final_t, n_contrib=n_contrib, depth_acc=depth_acc,
        pair_counts=pair_counts, prep=prep, campos=campos,
        inverse_vp=inverse_vp, width=width, height=height, tile=tile)
    field = field.detach()
    lo, hi, mean, std = field_stats(field)
    if data is not None:
        data.minimum = float(lo)
        data.maximum = float(hi)
        data.mean = float(mean)
        data.std = float(std)
        if data.debug_pixel is not None:
            x, y = data.debug_pixel
            data.debug_pixel_value = float(field[y, x])
        if data.data_callback is not None:
            data.data_callback(data)
    return apply_colormap(normalize_field(field, lo, hi), table)
