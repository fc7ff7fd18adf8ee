"""Global (tile, depth) sort and tile-range identification on torch tensors.

Port of the semantics of ``stopthepop_tpu/ops/sort.py``. The reference packs
``tile_id << 32 | float_bits(depth)`` into a 64-bit key for CUB's radix sort
(rasterizer_impl.cu:37-52, 344-362); so does the port, through
``torch.sort(stable=True)``. The bit pattern of a non-negative float orders
like the float, and every depth that reaches the sort is non-negative
(view-space z past the z > 0.2 cull, a distance to the camera, or a per-tile
depth clamped at 0). The sort is stable, like
``jax.lax.sort``, so depth ties resolve to the order of the input stream.
Per-tile [start, end) ranges come from ``torch.searchsorted`` on the sorted
tile ids (the reference's identifyTileRanges, rasterizer_impl.cu:133-158).
"""

from __future__ import annotations

import torch


def sort_pairs(tile_ids, depths, values):
    """Sort (tile, depth, value) triples by tile, then depth, stably.

    Args:
      tile_ids: [N] integer tile ids (>= 0).
      depths:   [N] float32, all >= 0 (-0.0 sorts as 0.0).
      values:   [N] payload (Gaussian ids).

    Returns sorted (tile_ids, depths, values) and the permutation ``order``
    [N] int64: sorted slot s holds input element ``order[s]``.
    """
    # -0.0 (a per-tile depth clamped at 0) has its sign bit set: make it
    # +0.0 so that it ties with 0.0, as it does in jax.lax.sort, and keep
    # the depth's bits in the key's low word only.
    canon = torch.where(depths == 0.0, torch.zeros_like(depths), depths)
    depth_bits = canon.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    key = (tile_ids.to(torch.int64) << 32) | depth_bits
    _, order = torch.sort(key, stable=True)
    return tile_ids[order], depths[order], values[order], order


def identify_tile_ranges(sorted_tile_ids, num_tiles: int):
    """Per-tile [start, end) ranges into the sorted pair list.

    Returns (starts [num_tiles], ends [num_tiles]) int32.
    """
    tids = torch.arange(num_tiles, dtype=sorted_tile_ids.dtype,
                        device=sorted_tile_ids.device)
    starts = torch.searchsorted(sorted_tile_ids, tids, side="left")
    ends = torch.searchsorted(sorted_tile_ids, tids, side="right")
    return starts.to(torch.int32), ends.to(torch.int32)
