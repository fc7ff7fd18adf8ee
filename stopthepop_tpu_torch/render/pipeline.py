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
"""

from __future__ import annotations

from ..config import GlobalSortOrder
from ..constants import TILE_X, TILE_Y
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
    if tile_based_culling:
        raise NotImplementedError(
            "tile_based_culling is not ported yet: it comes with ROADMAP.md "
            "Queue 1 item 4 (rest)."
        )
    grid_x, grid_y = tile_grid(image_width, image_height)
    pairs = build_pairs(prep, grid_x=grid_x, grid_y=grid_y,
                        sort_order=sort_order)
    color, final_t, n_contrib, depth_acc = blend_global_forward(
        pairs.gauss_id, pairs.starts, pairs.ends,
        prep.mean2d.contiguous(), prep.conic_opacity.contiguous(),
        prep.rgb.contiguous(), prep.depth.contiguous(),
        grid_x=grid_x, grid_y=grid_y, width=image_width, height=image_height,
    )
    # Background composite outside the kernel, as in the JAX package.
    color = color + final_t[None, :, :] * bg[:, None, None]
    return color, final_t, n_contrib, pairs, depth_acc
