"""GLOBAL blend, backward: gradients of the GLOBAL blend's outputs.

The backward replays the forward and forms, at each blend, the gradient of
the pixel's colour and final T with respect to the pair's alpha (from the
running prefix of the colour), then the nine terms (x, y, conic a, b, c,
opacity, r, g, b), summed over the tile's pixels and added into the
Gaussian's row.
"""

from __future__ import annotations

import torch

from .blend_global import _step, pack, tile_pixels
from .preprocess import ALPHA_MAX, ALPHA_THRESHOLD, T_THRESHOLD, TILE


def blend_global_backward(pairs, prep, color, final_t, grad_color,
                          grad_final_t, width: int, height: int):
    """Gradients [P, 9] (x, y, a, b, c, opacity, r, g, b) of the blend's
    ``color`` (raw, before any background) and ``final_t``."""
    dev = prep.mean2d.device
    gx, gy = -(-width // TILE), -(-height // TILE)
    px, py, inside, flat = tile_pixels(gx, gy, width, height, dev)
    xy, co, rgb = prep.mean2d, prep.conic_opacity, prep.rgb
    seg = pairs.ends - pairs.starts
    g_img = pack(grad_color, inside, flat)                    # [3, T, 256]
    c_img = pack(color, inside, flat)
    s_tot = (c_img * g_img).sum(dim=0)
    k_t = pack(grad_final_t * final_t, inside, flat)
    out = torch.zeros((xy.shape[0], 9), device=dev)
    T = torch.ones(px.shape, device=dev)
    prefix = torch.zeros_like(T)
    done = ~inside
    for k in range(int(seg.max()) if seg.numel() else 0):
        live, g, dx, dy, (a, b, c, o), power, alpha_raw = _step(
            k, pairs, seg, xy, co, px, py)
        alpha = torch.clamp(alpha_raw, max=ALPHA_MAX)
        test_t = T * (1.0 - alpha)
        ok = live[:, None] & ~done & (power >= 0.0) & (alpha >= ALPHA_THRESHOLD)
        stop = ok & (test_t < T_THRESHOLD)
        blend = ok & ~stop
        w = alpha * T
        cg = (rgb[g].T[:, :, None] * g_img).sum(dim=0)
        prefix = torch.where(blend, prefix + w * cg, prefix)
        galpha = cg * T - (s_tot - prefix + k_t) / (1.0 - alpha)
        galpha = torch.where(alpha_raw < ALPHA_MAX, galpha, 0.0)
        dpower = -alpha * galpha
        terms = torch.stack([
            dpower * (a * dx + b * dy), dpower * (c * dy + b * dx),
            dpower * 0.5 * dx * dx, dpower * dx * dy, dpower * 0.5 * dy * dy,
            galpha * alpha / torch.clamp(o, min=1e-12),
            w * g_img[0], w * g_img[1], w * g_img[2]], dim=-1)
        sums = torch.where(blend[..., None], terms, 0.0).sum(dim=1)   # [T, 9]
        out.index_add_(0, g[live], sums[live])
        T = torch.where(blend, test_t, T)
        done = done | stop
    return out


def backward(pairs, prep, color, final_t, grad_color, cfg: dict, cam):
    """The mode's backward entry (``render.py``): the gradients of a loss
    on ``color`` alone, by the preprocess field they belong to. GLOBAL's
    order is the tile's, so ``cam`` is not used."""
    g9 = blend_global_backward(pairs, prep, color, final_t, grad_color,
                               torch.zeros_like(final_t), cfg["width"],
                               cfg["height"])
    return {"mean2d": g9[:, 0:2], "conic_opacity": g9[:, 2:6], "rgb": g9[:, 6:9]}
