"""PER_PIXEL_FULL blend: every pixel sorts its whole tile's stream by the
depth along its own ray and blends it front to back.

StopThePop's quality oracle, renderSortedFullCUDA (resorted_render.cuh:
474-675), as the program states the mode: each pixel evaluates every pair
of its 16x16 tile's (tile, depth)-sorted segment. At the pixel centre
(x, y), power = 0.5 (a dx^2 + c dy^2) + b dx dy and alpha = min(0.99,
o exp(-power)); t = (u . d) / max(1e-5, d^T Sigma^-1 d) is the depth of the
pair's largest contribution along the pixel's view ray d. A pair is active
where power >= 0, alpha >= 1/255 and t >= 0. The actives are sorted by t,
stably, so that exact ties keep stream order, and blended front to back:
S += log1p(-alpha), U = exp(S); the pixel stops at the first active with
U < 1e-4, without blending it; otherwise w = alpha T, C += w rgb, T = U.

Departures from the published kernel, none of which moves a frame beyond
rounding:

* it keeps T as the running product T (1 - alpha); this sums log1p(-alpha)
  and takes exp, as the program and the JAX package's oracle
  (render/naive.py) define the mode, which rounds differently;
* its radix sort orders -0.0 before +0.0; here they tie, as IEEE compares
  them, and keep stream order;
* its blocks sort all of a tile's pairs for every pixel with one thread
  blending; here the [tiles, 256, count] tables of a chunk of tiles are
  sorted per pixel with ``torch.sort(stable=True)`` and the sorted
  positions are walked in order, the chunks sized so that the tables fit
  on one card at a published scene's size.
"""

from __future__ import annotations

import torch

from .blend_global import tile_pixels, unpack
from .preprocess import (
    ALPHA_MAX,
    ALPHA_THRESHOLD,
    T_THRESHOLD,
    TILE,
    compute_view_ray,
    depth_along_ray,
)

# (pixel, pair) entries a chunk's tables hold at most.
CHUNK_ENTRIES = 1 << 25
# Walk steps between looks at whether a chunk's pixels are all done.
DONE_EVERY = 32


def _chunks(seg, per_tile: int):
    """[t0, t1) ranges of tiles whose tables hold at most CHUNK_ENTRIES
    entries (a tile longer than that alone)."""
    out, t0, longest = [], 0, 0
    for t, n in enumerate(seg.tolist()):
        if t > t0 and per_tile * max(longest, n) * (t + 1 - t0) > CHUNK_ENTRIES:
            out.append((t0, t))
            t0, longest = t, 0
        longest = max(longest, n)
    if t0 < len(seg):
        out.append((t0, len(seg)))
    return out


def blend_ppx_full(pairs, prep, cam, width: int, height: int,
                   counts: dict | None = None):
    """(color [3, H, W], final_T [H, W]) of the exact per-pixel sort.
    ``cam`` holds ``inverse_vp`` and ``campos``. With a dict ``counts``,
    adds ``evaluations`` (every pair of a tile at each of its pixels on the
    image), ``actives`` and ``commits`` (blended entries)."""
    dev = prep.mean2d.device
    gx, gy = -(-width // TILE), -(-height // TILE)
    px, py, inside, flat = tile_pixels(gx, gy, width, height, dev)
    vd = compute_view_ray(torch.stack([px, py], dim=-1), width, height,
                          cam.inverse_vp, cam.campos)
    xy, co, rgb, inv9 = prep.mean2d, prep.conic_opacity, prep.rgb, prep.cov3d_inv9
    seg = pairs.ends - pairs.starts
    out_C = torch.zeros((3, *px.shape), device=dev)
    out_T = torch.ones(px.shape, device=dev)
    n_act = torch.zeros((), dtype=torch.int64, device=dev)
    n_commit = torch.zeros((), dtype=torch.int64, device=dev)
    for t0, t1 in _chunks(seg.cpu(), TILE * TILE):
        length = int(seg[t0:t1].max())
        if length == 0:
            continue
        k = torch.arange(length, device=dev)
        live = k[None, :] < seg[t0:t1, None]
        gid = pairs.gauss_id[torch.where(live, pairs.starts[t0:t1, None] + k, 0)]
        # [c, 256, length] tables, pairs in stream order.
        dx = xy[gid, 0][:, None, :] - px[t0:t1, :, None]
        dy = xy[gid, 1][:, None, :] - py[t0:t1, :, None]
        a, b, c, o = (co[gid, i][:, None, :] for i in range(4))
        power = 0.5 * (a * dx * dx + c * dy * dy) + b * dx * dy
        alpha = torch.clamp(o * torch.exp(-power), max=ALPHA_MAX)
        depth = depth_along_ray(inv9[gid][:, None, :, :],
                                vd[t0:t1, :, None, :])
        active = (live[:, None, :] & inside[t0:t1, :, None] & (power >= 0.0)
                  & (alpha >= ALPHA_THRESHOLD) & (depth >= 0.0))
        del dx, dy, a, b, c, o, power
        # -0.0 + 0.0 is +0.0: the two zeros tie.
        key = torch.where(active, depth + 0.0, float("inf"))
        order = torch.sort(key, dim=-1, stable=True).indices
        del key, depth
        a_s = torch.gather(alpha, -1, order)
        act_s = torch.gather(active, -1, order)
        g_s = torch.gather(gid[:, None, :].expand_as(order), -1, order)
        del alpha, order
        n_pix = act_s.sum(dim=-1)
        n_act += n_pix.sum()
        shape = px[t0:t1].shape
        S = torch.zeros(shape, device=dev)
        T = torch.ones(shape, device=dev)
        C = torch.zeros((3, *shape), device=dev)
        done = torch.zeros(shape, dtype=torch.bool, device=dev)
        for i in range(int(n_pix.max())):
            if i % DONE_EVERY == 0 and i and bool((done | (n_pix <= i)).all()):
                break
            a_i = a_s[..., i]
            go = act_s[..., i] & ~done
            S1 = S + torch.log1p(-a_i)
            U = torch.exp(S1)
            commit = go & (U >= T_THRESHOLD)
            w = a_i * T
            C = torch.where(commit, C + w * rgb[g_s[..., i]].permute(2, 0, 1), C)
            T = torch.where(commit, U, T)
            S = torch.where(commit, S1, S)
            n_commit += commit.sum()
            done = done | (go & ~commit)
        out_C[:, t0:t1], out_T[t0:t1] = C, T
    if counts is not None:
        n_eval = (seg * inside.sum(dim=-1)).sum()
        for name, v in (("evaluations", n_eval), ("actives", n_act),
                        ("commits", n_commit)):
            counts[name] = counts.get(name, 0) + int(v)
    return (unpack(out_C, inside, flat, width, height),
            unpack(out_T, inside, flat, width, height))


def blend(pairs, prep, cam, cfg: dict, counts: dict | None = None):
    """The mode's entry (``render.py``): (color, final_T) of the frame."""
    return blend_ppx_full(pairs, prep, cam, cfg["width"], cfg["height"],
                          counts)
