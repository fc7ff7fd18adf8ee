"""Tiled rendering pipeline: preprocess -> duplicate -> sort -> blend (torch).

Port of ``stopthepop_tpu/render/pipeline.py::render_tiled`` for the GLOBAL
sort mode (the analog of Rasterizer::forward, rasterizer_impl.cu:221-413):

  stage          reference                         here
  -------------  --------------------------------  ---------------------------
  preprocess     preprocessCUDA (1 thread/gauss)   torch ops (render/preprocess)
  scan+alloc     CUB InclusiveSum + D2H resize     cumsum + one D2H read
  duplicate      duplicateWithKeys                 repeat_interleave expansion
  sort           CUB DeviceRadixSort (64-bit key)  torch.sort on the same key
  ranges         identifyTileRanges kernel         searchsorted
  render         renderCUDA                        kernel K1 (kernels/global_blend)
  render bwd     renderCUDA backward (atomicAdd)   kernel K2 + a deterministic
                                                   per-Gaussian segmented sum
                                                   (kernels/blend_vjp)

With any per-Gaussian row requiring grad (and grad mode on) the blend goes
through ``BlendGlobal``; otherwise K1 is called directly.
"""

from __future__ import annotations

import torch

from ..config import GlobalSortOrder
from ..constants import TILE_X, TILE_Y
from ..kernels.blend_vjp import BlendGlobal
from ..kernels.global_blend import blend_global_forward
from .duplicate import build_pairs
from .preprocess import PreprocessOutput


def tile_grid(width: int, height: int):
    return (width + TILE_X - 1) // TILE_X, (height + TILE_Y - 1) // TILE_Y


def render_tiled(
    prep: PreprocessOutput,
    bg,
    *,
    image_width: int,
    image_height: int,
    sort_order: GlobalSortOrder = GlobalSortOrder.Z_DEPTH,
    tile_based_culling: bool = False,
):
    """GLOBAL-mode tiled render.

    Returns (color [3, H, W], final_T [H, W], n_contrib [H, W], pairs,
    depth_acc [H, W]), as the JAX package's ``render_tiled`` does.
    """
    grid_x, grid_y = tile_grid(image_width, image_height)
    pairs = build_pairs(prep, grid_x=grid_x, grid_y=grid_y,
                        sort_order=sort_order,
                        tile_based_culling=tile_based_culling)
    rows = (prep.mean2d.contiguous(), prep.conic_opacity.contiguous(),
            prep.rgb.contiguous())
    depth = prep.depth.detach().contiguous()
    kw = dict(grid_x=grid_x, grid_y=grid_y, width=image_width,
              height=image_height)
    if torch.is_grad_enabled() and any(r.requires_grad for r in rows):
        color, final_t, n_contrib, depth_acc = BlendGlobal.apply(
            *rows, depth, pairs, grid_x, grid_y, image_width, image_height)
    else:
        color, final_t, n_contrib, depth_acc = blend_global_forward(
            pairs.gauss_id, pairs.starts, pairs.ends, *rows, depth, **kw)
    # Background composite outside the kernel, as in the JAX package: autograd
    # gives d_bg and folds the background into the final_T cotangent.
    color = color + final_t[None, :, :] * bg[:, None, None]
    return color, final_t, n_contrib, pairs, depth_acc
