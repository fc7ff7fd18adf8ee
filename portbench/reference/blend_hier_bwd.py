"""HIERARCHICAL blend, backward: gradients of the cascade's colour.

The backward replays the forward's cascade (``blend_hier.blend_hier``, the
code that renders the compared frames, not a copy of it) and takes each
commit as the cascade makes it: at every head pop the cascade hands over
the pixels that commit an entry with alpha > 0, the entry's Gaussian, its
alpha a and the pixel's T before it. A pixel's commits come in its own
compositing order, so the gradient is GLOBAL's front-to-back arithmetic
(``blend_global_bwd.py``) taken per pixel in the order the cascade commits,
in place of per tile in stream order:

  w = a T;  prefix = prefix + w (c.g);
  galpha = a < 0.99 ? (c.g) T - (S_tot - prefix) / (1 - a) : 0,

with c.g the entry's rgb against the pixel's colour cotangent g and S_tot =
color . g, then the nine terms (x, y, conic a, b, c, opacity, r, g, b) from
dpower = -a galpha, each added into its Gaussian's row. No gradient flows
into the ray depths, the camera or the culling thresholds: they only choose
the order and which entries have alpha 0, as in the program's
``render/pipeline.py::render_tiled_hier``. The loss is on the colour alone,
so final T gets no cotangent. The cascade's state is the forward's, one
[tiles, 256] plane a field; what a commit adds is gathered for the
committing pixels alone and leaves when the call ends, so no tile chunks
are needed.

Where it departs from the program's K6 (``kernels/hier_blend.py::
blend_hier_backward``): K6 sums each commit's terms per warp of 32 pixels
and pair, in lane order, then a pair's warp rows, and the program sums a
Gaussian's pair rows after; here each head pop's terms go straight into
the Gaussian's row (``index_put_`` with ``accumulate``: a stable order by
Gaussian, then pixel, and the pops in cascade order). K6 stops a pixel
after the forward's ``n_contrib`` commits; the replay runs the whole
cascade, which commits nothing more after a pixel's last commit. Both sum
in float32, so the two differ by rounding alone.
"""

from __future__ import annotations

import torch

from .blend_global import pack, tile_pixels
from .blend_hier import blend_hier
from .preprocess import ALPHA_MAX, TILE


def blend_hier_backward(pairs, prep, cam, color, grad_color, width: int,
                        height: int, queues):
    """Gradients [P, 9] (x, y, a, b, c, opacity, r, g, b) of the cascade's
    raw ``color`` (before any background) under the cotangent
    ``grad_color`` [3, H, W]."""
    dev = prep.mean2d.device
    gx, gy = -(-width // TILE), -(-height // TILE)
    px, py, inside, flat = tile_pixels(gx, gy, width, height, dev)
    px, py = px.reshape(-1), py.reshape(-1)
    g_img = pack(grad_color, inside, flat).reshape(3, -1)     # [3, T * 256]
    s_tot = (pack(color, inside, flat).reshape(3, -1) * g_img).sum(dim=0)
    xy, co, rgb = prep.mean2d, prep.conic_opacity, prep.rgb
    prefix = torch.zeros_like(s_tot)
    out = torch.zeros((xy.shape[0], 9), device=dev)

    def on_commit(tile, lit, a0, T, gid):
        r, j = lit.nonzero(as_tuple=True)
        if r.numel() == 0:
            return
        p = tile[r] * (TILE * TILE) + j
        g, a, t = gid[r, j], a0[r, j], T[r, j]
        gp = g_img[:, p]
        cg = (rgb[g] * gp.T).sum(dim=-1)
        w = a * t
        prefix[p] = prefix[p] + w * cg
        galpha = torch.where(a < ALPHA_MAX,
                             cg * t - (s_tot[p] - prefix[p]) / (1.0 - a), 0.0)
        dpower = -a * galpha
        dx, dy = xy[g, 0] - px[p], xy[g, 1] - py[p]
        ca, cb, cc, o = co[g].unbind(-1)
        terms = torch.stack([
            dpower * (ca * dx + cb * dy), dpower * (cc * dy + cb * dx),
            dpower * 0.5 * dx * dx, dpower * dx * dy, dpower * 0.5 * dy * dy,
            galpha * a / torch.clamp(o, min=1e-12),
            w * gp[0], w * gp[1], w * gp[2]], dim=-1)
        out.index_put_((g,), terms, accumulate=True)

    blend_hier(pairs, prep, cam, width, height, queues, on_commit=on_commit)
    return out


def backward(pairs, prep, color, final_t, grad_color, cfg: dict, cam):
    """The mode's backward entry (``render.py``): the gradients of a loss
    on ``color`` alone, by the preprocess field they belong to."""
    g9 = blend_hier_backward(pairs, prep, cam, color, grad_color, cfg["width"],
                             cfg["height"], tuple(cfg["queues"]))
    return {"mean2d": g9[:, 0:2], "conic_opacity": g9[:, 2:6], "rgb": g9[:, 6:9]}
