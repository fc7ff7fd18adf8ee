"""Pairs of (binning tile, Gaussian), sorted by tile and then depth.

The reference rasterizer's duplicate + radix sort + identifyTileRanges
(rasterizer_impl.cu:37-52, 133-158, 344-362): one pair per tile of each
Gaussian's rect, keyed ``tile << 32 | float bits(depth)`` and sorted
stably, so that depth ties keep the Gaussian-major order of the expansion.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Pairs(NamedTuple):
    gauss_id: torch.Tensor  # [N] int64, sorted by (tile, depth)
    starts: torch.Tensor    # [T] int64 range of each tile
    ends: torch.Tensor      # [T] int64


def build_pairs(prep, grid_x: int, grid_y: int) -> Pairs:
    touched = prep.tiles_touched.to(torch.int64)
    n = int(touched.sum())
    dev = touched.device
    g = torch.repeat_interleave(torch.arange(touched.shape[0], device=dev),
                                touched, output_size=n)
    local = torch.arange(n, device=dev) - (torch.cumsum(touched, 0) - touched)[g]
    lo = prep.rect_min.to(torch.int64)[g]
    w = (prep.rect_max[:, 0] - prep.rect_min[:, 0]).to(torch.int64)[g]
    tile = (lo[:, 1] + local // w) * grid_x + lo[:, 0] + local % w
    depth = prep.depth.detach()[g]
    depth = torch.where(depth == 0.0, torch.zeros_like(depth), depth)
    bits = depth.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    order = torch.sort((tile << 32) | bits, stable=True).indices
    tile = tile[order]
    ids = torch.arange(grid_x * grid_y, device=dev)
    return Pairs(g[order], torch.searchsorted(tile, ids, side="left"),
                 torch.searchsorted(tile, ids, side="right"))
