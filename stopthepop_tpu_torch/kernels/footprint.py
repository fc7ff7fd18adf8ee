"""Per-warp footprint culling of staged pairs: the plain mirror of
``csrc/footprint_common.cuh``, which kernels K1, K2 and K3 use.

A 16x16 tile's 256 pixels are 8 warps of 32; warp w covers a ``shape`` =
(WW, WH) rectangle of the tile, (16, 2) or (8, 4), lanes row-major inside
it. ``warp_footprint_mask`` returns, for each pair, an 8-bit mask whose bit
w is clear only where no pixel of warp w's rectangle can pass the pair's
alpha test (power >= 0 and min(0.99, o exp(-power)) >= 1/255): the pair is
kept where the rectangle meets the bounding box of the ellipse
0.5 d^T C d <= L, L = ln(255 o) widened by a margin for float rounding.
Non-positive-definite or near-singular conics and non-finite values keep the
pair everywhere; an opacity below 1/255 culls it everywhere. The header's
notes say why the margin covers the rounding.
"""

from __future__ import annotations

import torch

from ..constants import ALPHA_THRESHOLD, TILE_PIXELS, TILE_X

WARPS = TILE_PIXELS // 32
SHAPES = ((16, 2), (8, 4))
# The header's margins (footprint_common.cuh).
DET_GUARD = 1.0e-3
LEVEL_SCALE = 1.02
LEVEL_PAD = 1.0e-4
EXTENT_SCALE = 1.01
EXTENT_PAD = 1.0e-3


def _f32(x):
    return torch.tensor(x, dtype=torch.float32)


def warp_rects(shape):
    """[8, 2] (x, y) offset of each warp's rectangle in the tile."""
    ww, wh = shape
    if ww * wh != 32 or TILE_X % ww:
        raise ValueError(f"a warp footprint is 32 pixels across a 16-wide tile, got {shape}")
    across = TILE_X // ww
    w = torch.arange(WARPS)
    return torch.stack([(w % across) * ww, (w // across) * wh], dim=1)


def thread_pixels(shape):
    """[256] index of thread t's pixel in the tile's row-major order."""
    ww, wh = shape
    off = warp_rects(shape)
    lane = torch.arange(32)
    x = off[:, 0:1] + lane % ww
    y = off[:, 1:2] + lane // ww
    return (y * TILE_X + x).reshape(-1)


def warp_footprint_mask(xy, conic_opacity, tile_origin, shape):
    """[N] int32 masks (bit w: warp w may pass the pair) of pairs at ``xy``
    [N, 2] with ``conic_opacity`` [N, 4], in tiles whose pixel (0, 0) is
    ``tile_origin`` [N, 2] (float32), for warps of ``shape`` pixels."""
    dev = xy.device
    rect = warp_rects(shape).to(dev, torch.float32)      # [8, 2]
    ww, wh = shape
    mx, my = xy[:, 0:1], xy[:, 1:2]
    a, b, c, o = (conic_opacity[:, i:i + 1] for i in range(4))
    x0 = tile_origin[:, 0:1] + rect[:, 0]                # [N, 8]
    y0 = tile_origin[:, 1:2] + rect[:, 1]
    x1 = x0 + float(ww - 1)
    y1 = y0 + float(wh - 1)
    det = a * c - b * b
    level = (torch.clamp(torch.log(255.0 * o), min=0.0) * LEVEL_SCALE
             + LEVEL_PAD)
    hx = torch.sqrt(2.0 * level * c / det) * EXTENT_SCALE + EXTENT_PAD
    hy = torch.sqrt(2.0 * level * a / det) * EXTENT_SCALE + EXTENT_PAD
    hit = ((x0 - mx <= hx) & (x1 - mx >= -hx)
           & (y0 - my <= hy) & (y1 - my >= -hy))
    finite = torch.isfinite(hx) & torch.isfinite(hy)
    bits = (1 << torch.arange(WARPS, device=dev, dtype=torch.int32))
    mask = torch.where(hit, bits, 0).sum(dim=1, dtype=torch.int32)
    all_warps = (1 << WARPS) - 1
    keep_all = ~(torch.isfinite(o) & torch.isfinite(mx) & torch.isfinite(my))[:, 0]
    cull_all = ~keep_all & (o < _f32(ALPHA_THRESHOLD))[:, 0]
    pd = (a > 0.0) & (c > 0.0) & (det > _f32(DET_GUARD) * (a * c))
    keep_all = keep_all | (~cull_all & ~(pd[:, 0] & finite[:, 0]))
    mask = torch.where(keep_all, all_warps, mask)
    return torch.where(cull_all, 0, mask)


def tile_origins(grid_x: int, num_tiles: int, device):
    """[T, 2] float32 pixel (0, 0) of each 16x16 tile of a ``grid_x``-wide
    grid, tiles row-major."""
    tile = torch.arange(num_tiles, device=device)
    return torch.stack([(tile % grid_x) * TILE_X, (tile // grid_x) * TILE_X],
                       dim=1).to(torch.float32)


class WarpCounter:
    """What a kernel that culls by footprint does per (warp, pair) step of
    a replay that visits position j of every tile's segment at once
    (states [T, 256], pixels row-major; the tiles' pixel (0, 0) at
    ``origin`` [T, 2], so that tiles which share a segment each test it
    against their own warps). ``counts``:

    * ``warp_pairs``: (warp, live pair) steps with some lane not yet done;
    * ``warp_pairs_kept``: those the footprint test keeps (the steps whose
      alphas the kernel evaluates), ``evaluations_kept`` their not-done
      lanes;
    * ``warp_pass_steps``: steps at which some lane passes (``step``'s
      ``passed``);
    * ``chunk_max_passes``: per (warp, chunk of 32 segment positions), the
      most passes of one lane, summed (the rounds of K3's second phase).
    """

    def __init__(self, point_list, xy, conic_opacity, origin, shape):
        self.perm = thread_pixels(shape).to(xy.device)
        self.warp_of = torch.empty_like(self.perm)   # each pixel's warp
        self.warp_of[self.perm] = torch.arange(TILE_PIXELS,
                                               device=xy.device) // 32
        self.rows = (point_list, xy, conic_opacity)
        self.origin, self.shape = origin, shape
        self.chunk = None
        self.j = 0
        self.counts = dict.fromkeys(
            ("warp_pairs", "warp_pairs_kept", "evaluations_kept",
             "warp_pass_steps", "chunk_max_passes"), 0)

    def _warps(self, x):
        return x[:, self.perm].reshape(x.shape[0], WARPS, 32)

    def kept(self, pos):
        """[T, 256] (pixels row-major): whether each pixel's warp keeps the
        pair at sorted slot ``pos`` [T] of its tile."""
        point_list, xy, conic_opacity = self.rows
        gid = point_list[pos].to(torch.int64)
        masks = warp_footprint_mask(xy[gid], conic_opacity[gid], self.origin,
                                    self.shape)
        return ((masks[:, None] >> self.warp_of) & 1) != 0

    def step(self, pos, active, passed):
        """Position j (``pos`` [T] the sorted slots, any value where the
        tile's segment is over, where ``active`` is all False)."""
        act = self._warps(active)
        live = act.any(dim=-1)
        kept = live & self._warps(self.kept(pos)).any(dim=-1)
        c = self.counts
        c["warp_pairs"] += int(live.sum())
        c["warp_pairs_kept"] += int(kept.sum())
        c["evaluations_kept"] += int((act & kept[..., None]).sum())
        p = self._warps(passed)
        c["warp_pass_steps"] += int(p.any(dim=-1).sum())
        self.chunk = p.to(torch.int32) if self.chunk is None else self.chunk + p
        self.j += 1
        if self.j % 32 == 0:
            self.close()

    def close(self):
        """End the current chunk (at every 32nd position, and after the
        last)."""
        if self.chunk is not None:
            self.counts["chunk_max_passes"] += int(
                self.chunk.amax(dim=-1).sum())
            self.chunk = None
