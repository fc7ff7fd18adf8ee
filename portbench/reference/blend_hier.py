"""HIERARCHICAL blend: StopThePop's cascade of sorted windows per tile.

A frozen copy of the program's plain replay of the per-entry cascade
(the reference's hierarchical_render.cuh:207-1035), without hierarchical
4x4 culling. Every pixel reads its 16x16 tile's (tile, depth)-sorted pair
stream through three windows:

* tail, one per 4x4 sub-tile, ``kt`` entries keyed by the depth along the
  ray through the sub-tile centre. It takes the stream in batches of 64:
  the hold and the batch are sorted together stably, the first 64 are
  emitted in that order and the last ``kt`` held; ``ceil(kt / 64)`` batches
  of +inf drain it. Entries with a negative key are ghosts (-inf);
* mid, one per 2x2 quad, ``km`` entries keyed by the depth along the ray
  through the quad centre; every emitted finite entry goes in behind all
  entries of equal or smaller key, a full window first popping its front
  into the head;
* head, one per pixel, ``kh`` entries keyed by the depth along the pixel's
  own ray, with the same rule. A head pop blends: U = T (1 - a) commits
  where the pixel is not done and U >= 1e-4; U < 1e-4 sets the done latch.

An entry keeps its slot in every pixel of its sub-tile, also where its
alpha there is 0. After the stream the mid, then the head windows are
emptied through the blend.
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

TAIL_BATCH = 64
SUBTILES = 16
INF = float("inf")


def _shift_out(x, popm, pad):
    shifted = torch.cat([x[1:], torch.full_like(x[:1], pad)], dim=0)
    return torch.where(popm, shifted, x)


def _insert(win, ins, d_new, new):
    """Insert behind every entry of equal or smaller key where ``ins``."""
    k = win["d"].shape[0]
    pos = (win["d"] <= d_new).sum(dim=0)
    ik = torch.arange(k, device=pos.device)[:, None, None]
    out = {}
    for name, x in win.items():
        shifted = torch.cat([x[:1], x[:-1]], dim=0)
        put = torch.where(ik < pos, x, torch.where(ik == pos, new[name], shifted))
        out[name] = torch.where(ins, put, x)
    return out


def blend_hier(pairs, prep, cam, width: int, height: int, queues,
               counts: dict | None = None, on_commit=None):
    """(color [3, H, W], final_T [H, W]) of the cascade with window sizes
    ``queues`` = (kt, km, kh). ``cam`` holds ``inverse_vp`` and ``campos``.
    With a dict ``counts``, adds what the cascade needs of the pixels that
    are not done: ``tail_keys`` (sub-tile keys of stream positions, per
    live tile), ``tail_slots`` (entries placed by the tail merges),
    ``evaluations`` (alpha and head depth of an emitted entry at a pixel),
    ``mid_inserts`` (per quad), ``head_inserts`` (per pixel) and
    ``commits`` (blends with alpha > 0).

    ``on_commit(tile, lit, a, T, gid)``, where given, is called at every
    head pop with the rows' tile ids [t], the [t, 256] mask of the pixels
    that commit an entry with alpha > 0, the entries' alpha, the pixels' T
    before the commit and the entries' Gaussian ids; it only reads them, so
    the frame is the same with or without it. A pixel commits at most once
    a call, and its calls come in its compositing order.

    Tiles are independent: a tile whose stream is consumed is drained
    (its pad batches, then its mid and head windows) and leaves the state,
    so that the deep tiles' long streams step a few tiles only."""
    kt, km, kh = queues
    dev = prep.mean2d.device
    gx, gy = -(-width // TILE), -(-height // TILE)
    n_tiles = gx * gy
    px, py, inside, flat = tile_pixels(gx, gy, width, height, dev)
    xy, co, rgb = prep.mean2d, prep.conic_opacity, prep.rgb
    inv9 = prep.cov3d_inv9
    seg = pairs.ends - pairs.starts
    max_count = int(seg.max()) if seg.numel() else 0
    n_pairs = pairs.gauss_id.shape[0]
    n = {k: torch.zeros((), dtype=torch.int64, device=dev) for k in (
        "tail_keys", "tail_slots", "evaluations", "mid_inserts",
        "head_inserts", "commits")}

    def rays(fx, fy):
        return compute_view_ray(torch.stack([fx, fy], dim=-1), width, height,
                                cam.inverse_vp, cam.campos)

    tiles = torch.arange(n_tiles, device=dev)[:, None]
    sub = torch.arange(SUBTILES, device=dev)[None, :]
    st_x = ((tiles % gx) * TILE + (sub % 4) * 4).to(torch.float32)
    st_y = ((tiles // gx) * TILE + (sub // 4) * 4).to(torch.float32)
    j = torch.arange(TILE * TILE, device=dev)
    sub_of_pix = (j // (4 * TILE)) * 4 + (j % TILE) // 4
    shape = px.shape

    def window(k, fields):
        w = {"d": torch.full((k, *shape), INF, device=dev)}
        for f in fields:
            w[f] = torch.zeros((k, *shape), device=dev)
        w["src"] = torch.zeros((k, *shape), dtype=torch.int64, device=dev)
        return w

    # The live state, every tensor with its tile axis (1 in the windows and
    # the colour, else 0).
    S = {"id": tiles[:, 0], "starts": pairs.starts, "seg": seg, "px": px,
         "py": py, "vd_head": rays(px, py),
         "vd_mid": rays(torch.floor(px / 2.0) * 2.0 + 0.5,
                        torch.floor(py / 2.0) * 2.0 + 0.5),
         "vd_tail": rays(st_x + 1.5, st_y + 1.5),
         "mid": window(km, ("dh", "a")), "head": window(kh, ("a",)),
         "fm": torch.zeros(shape, dtype=torch.int64, device=dev),
         "fh": torch.zeros(shape, dtype=torch.int64, device=dev),
         "done": ~inside, "T": torch.ones(shape, device=dev),
         "C": torch.zeros((3, *shape), device=dev),
         "hold_k": torch.full((n_tiles, SUBTILES, kt), -INF, device=dev),
         "hold_s": torch.zeros((n_tiles, SUBTILES, kt), dtype=torch.int64,
                               device=dev),
         "live": torch.ones(n_tiles, dtype=torch.bool, device=dev)}
    out_C = torch.zeros((3, *shape), device=dev)
    out_T = torch.ones(shape, device=dev)

    def take(idx):
        return {k: ({f: x[:, idx] for f, x in v.items()} if isinstance(v, dict)
                    else v[:, idx] if k == "C" else v[idx])
                for k, v in S.items()}

    def gids(src):
        idx = S["starts"][:, None] + src
        return pairs.gauss_id[idx.clamp(0, max(n_pairs - 1, 0))]

    def shift(win, popm):
        return {f: _shift_out(x, popm, INF if f == "d" else 0.0)
                for f, x in win.items()}

    def blend(pop_h, a0, src):
        T = S["T"]
        U = T * (1.0 - a0)
        commit = pop_h & ~S["done"] & (U >= T_THRESHOLD)
        gid = gids(src)
        col = rgb[gid].permute(2, 0, 1)
        S["C"] = torch.where(commit, S["C"] + (a0 * T) * col, S["C"])
        S["T"] = torch.where(commit, U, T)
        lit = commit & (a0 > 0.0)
        n["commits"] += lit.sum()
        if on_commit is not None:
            on_commit(S["id"], lit, a0, T, gid)
        S["done"] = S["done"] | (pop_h & (U < T_THRESHOLD))

    def head_pop(pop_h):
        head = S["head"]
        blend(pop_h, head["a"][0], head["src"][0])
        S["head"] = shift(head, pop_h)
        S["fh"] = S["fh"] - pop_h.to(torch.int64)

    def push_head(pop_m):
        mid = S["mid"]
        front = {"d": mid["dh"][0], "a": mid["a"][0], "src": mid["src"][0]}
        n["head_inserts"] += (pop_m & ~S["done"]).sum()
        head_pop(pop_m & (S["fh"] == kh))
        S["head"] = _insert(S["head"], pop_m, front["d"], front)
        S["fh"] = S["fh"] + pop_m.to(torch.int64)
        S["mid"] = shift(mid, pop_m)
        S["fm"] = S["fm"] - pop_m.to(torch.int64)

    def evaluate(src):
        gid = gids(src)
        d_head = depth_along_ray(inv9[gid], S["vd_head"])
        c = co[gid]
        dx = xy[gid, 0] - S["px"]
        dy = xy[gid, 1] - S["py"]
        a, b, cc, o = c.unbind(-1)
        power = 0.5 * (a * dx * dx + cc * dy * dy) + b * dx * dy
        alpha = torch.clamp(o * torch.exp(-power), max=ALPHA_MAX)
        ok = (power >= 0.0) & (alpha >= ALPHA_THRESHOLD) & (d_head >= 0.0)
        return d_head, torch.where(ok, alpha, 0.0)

    def cascade(key_sub, src_sub):
        v = torch.isfinite(key_sub)[:, sub_of_pix]
        src = src_sub[:, sub_of_pix]
        d_mid = depth_along_ray(inv9[gids(src)], S["vd_mid"])
        d_head, a_eff = evaluate(src)
        busy = v & ~S["done"]
        n["evaluations"] += busy.sum()
        n["mid_inserts"] += busy.reshape(-1, 8, 2, 8, 2).any(4).any(2).sum()
        push_head(v & (S["fm"] == km))
        S["mid"] = _insert(S["mid"], v, d_mid,
                           {"d": d_mid, "dh": d_head, "a": a_eff, "src": src})
        S["fm"] = S["fm"] + v.to(torch.int64)

    def tail_round(key, srcs, ran):
        n["tail_slots"] += SUBTILES * (kt + TAIL_BATCH) * ran.sum()
        srt_k, order = torch.sort(torch.cat([S["hold_k"], key], dim=-1),
                                  dim=-1, stable=True)
        srt_s = torch.gather(torch.cat([S["hold_s"], srcs], dim=-1), -1, order)
        S["hold_k"], S["hold_s"] = srt_k[..., TAIL_BATCH:], srt_s[..., TAIL_BATCH:]
        emit_k, emit_s = srt_k[..., :TAIL_BATCH], srt_s[..., :TAIL_BATCH]
        for e in torch.isfinite(emit_k).any(dim=1).any(dim=0).nonzero().flatten().tolist():
            cascade(emit_k[..., e], emit_s[..., e])

    def drain():
        """Pad batches of +inf push the hold out, then the mid and head
        windows empty through the blend; the tiles' results go out."""
        t = S["id"].shape[0]
        for _ in range(-(-kt // TAIL_BATCH)):
            tail_round(torch.full((t, SUBTILES, TAIL_BATCH), INF, device=dev),
                       torch.zeros((t, SUBTILES, TAIL_BATCH), dtype=torch.int64,
                                   device=dev), S["live"])
        for _ in range(km):
            push_head(S["fm"] > 0)
        for _ in range(kh):
            head_pop(S["fh"] > 0)
        out_C[:, S["id"]] = S["C"]
        out_T[S["id"]] = S["T"]

    n_stream = -(-max_count // TAIL_BATCH)
    for b in range(n_stream):
        S["live"] = S["live"] & ~S["done"].all(dim=1)
        ended = S["seg"] <= b * TAIL_BATCH
        if bool(ended.any()):
            keep = take((~ended).nonzero().flatten())
            S.update(take(ended.nonzero().flatten()))
            drain()
            S.update(keep)
        t = S["id"].shape[0]
        pos = b * TAIL_BATCH + torch.arange(TAIL_BATCH, device=dev)
        live = pos[None, :] < S["seg"][:, None]
        gid = pairs.gauss_id[torch.where(live, S["starts"][:, None] + pos, 0)]
        d_tail = depth_along_ray(inv9[gid][:, None], S["vd_tail"][:, :, None])
        key = torch.where(live[:, None, :] & (d_tail >= 0.0), d_tail, -INF)
        n["tail_keys"] += SUBTILES * (live & S["live"][:, None]).sum()
        tail_round(key, pos.expand(t, SUBTILES, TAIL_BATCH), S["live"])
    S["live"] = S["live"] & ~S["done"].all(dim=1)
    drain()
    if counts is not None:
        for k, v in n.items():
            counts[k] = counts.get(k, 0) + int(v)
    return (unpack(out_C, inside, flat, width, height),
            unpack(out_T, inside, flat, width, height))


def blend(pairs, prep, cam, cfg: dict, counts: dict | None = None):
    """The mode's entry (``render.py``): (color, final_T) of the frame."""
    return blend_hier(pairs, prep, cam, cfg["width"], cfg["height"],
                      tuple(cfg["queues"]), counts)
