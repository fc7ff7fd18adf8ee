"""GLOBAL blend: every 16x16 tile's depth-sorted pairs, front to back.

The reference's renderCUDA (forward.cu:260-360): per pixel, alpha =
min(0.99, o exp(-power)) with power = 0.5 (a dx^2 + c dy^2) + b dx dy;
pairs with power < 0 or alpha < 1/255 are skipped; the pixel stops at the
first pair whose T (1 - alpha) would fall under 1e-4, without blending it.
All tiles are held as one [T, 256] state and stepped through the position
k in their segments. The GLOBAL image does not depend on the binning tile
(a bin's culled pairs have alpha < 1/255 at each of its pixels), so the
reference always bins 16x16.
"""

from __future__ import annotations

import torch

from .preprocess import ALPHA_MAX, ALPHA_THRESHOLD, T_THRESHOLD, TILE


def tile_pixels(grid_x: int, grid_y: int, width: int, height: int, device):
    """(x, y) [T, 256] float32 pixel coordinates of every 16x16 tile, the
    [T, 256] mask of those on the image and their flat index into H * W."""
    t = torch.arange(grid_x * grid_y, device=device)[:, None]
    j = torch.arange(TILE * TILE, device=device)[None, :]
    x = (t % grid_x) * TILE + j % TILE
    y = (t // grid_x) * TILE + j // TILE
    inside = (x < width) & (y < height)
    return (x.to(torch.float32), y.to(torch.float32), inside,
            torch.where(inside, y * width + x, 0))


def unpack(tiles, inside, flat, width: int, height: int):
    """[..., T, 256] -> [..., H, W]."""
    out = tiles.new_zeros((*tiles.shape[:-2], height * width))
    out[..., flat[inside]] = tiles[..., inside]
    return out.reshape(*tiles.shape[:-2], height, width)


def pack(img, inside, flat):
    """[..., H, W] -> [..., T, 256], zero off the image."""
    v = img.reshape(*img.shape[:-2], -1)[..., flat]
    return torch.where(inside, v, torch.zeros((), dtype=v.dtype))


def _step(k, pairs, counts, xy, co, px, py):
    live = k < counts
    g = pairs.gauss_id[torch.where(live, pairs.starts + k, 0)]
    dx = xy[g, 0][:, None] - px
    dy = xy[g, 1][:, None] - py
    a, b, c, o = (co[g, i:i + 1] for i in range(4))
    power = 0.5 * (a * dx * dx + c * dy * dy) + b * dx * dy
    alpha_raw = o * torch.exp(-power)
    return live, g, dx, dy, (a, b, c, o), power, alpha_raw


def blend_global(pairs, prep, width: int, height: int, counts: dict | None = None):
    """(color [3, H, W], final_T [H, W]) of the pairs; with a dict
    ``counts``, adds the blends (committed (pixel, pair) steps) under
    ``"blends"``."""
    dev = prep.mean2d.device
    gx, gy = -(-width // TILE), -(-height // TILE)
    px, py, inside, flat = tile_pixels(gx, gy, width, height, dev)
    xy, co, rgb = prep.mean2d, prep.conic_opacity, prep.rgb
    seg = pairs.ends - pairs.starts
    T = torch.ones(px.shape, device=dev)
    C = torch.zeros((3, *px.shape), device=dev)
    done = ~inside
    blends = torch.zeros((), dtype=torch.int64, device=dev)
    for k in range(int(seg.max()) if seg.numel() else 0):
        live, g, _, _, _, power, alpha_raw = _step(k, pairs, seg, xy, co, px, py)
        alpha = torch.clamp(alpha_raw, max=ALPHA_MAX)
        test_t = T * (1.0 - alpha)
        ok = live[:, None] & ~done & (power >= 0.0) & (alpha >= ALPHA_THRESHOLD)
        stop = ok & (test_t < T_THRESHOLD)
        blend = ok & ~stop
        C = C + rgb[g].T[:, :, None] * torch.where(blend, alpha * T, 0.0)
        T = torch.where(blend, test_t, T)
        done = done | stop
        blends += blend.sum()
    if counts is not None:
        counts["blends"] = counts.get("blends", 0) + int(blends)
    return unpack(C, inside, flat, width, height), unpack(T, inside, flat, width, height)


def blend(pairs, prep, cam, cfg: dict, counts: dict | None = None):
    """The mode's entry (``render.py``): (color, final_T) of the frame."""
    return blend_global(pairs, prep, cfg["width"], cfg["height"], counts)
