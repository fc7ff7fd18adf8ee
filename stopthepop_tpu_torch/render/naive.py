"""Dense reference renderers (torch, differentiable): the test oracles.

Port of ``stopthepop_tpu/render/naive.py``: ``render_global_naive`` (one
global depth order), ``render_full_sort_naive`` (PER_PIXEL_FULL),
``render_global_order_naive`` (GLOBAL under any stream order),
``render_kbuffer_naive`` (PER_PIXEL_KBUFFER) and
``render_hierarchical_naive`` (HIERARCHICAL, the per-entry or the batched
cascade), with the reference's sort-error accumulation (``sort_error=True``)
in the resort modes' pop order. They render in O(P x pixels) memory with no tiling, so
they serve small scenes only. ``render/rasterize.py`` takes the FULL oracle
for PER_PIXEL_FULL while P·W·H <= 2**26; the others are held against the
kernels' plain versions and the JAX oracles by the tests.

The reference's sequential per-pixel loop becomes a masked prefix product:
front to back, U_k = exp(sum_{i<=k} log1p(-alpha_i)), and the loop's early
exit (T < 1e-4 -> done) is the mask [U_k >= 1e-4], since U never rises.
The resort modes step through the stream one entry at a time over [K, N]
windows, as the JAX oracles do. Masks and thresholds are constants for the
gradient, as in the reference's CUDA backward.
"""

from __future__ import annotations

import torch

from ..config import GlobalSortOrder
from ..constants import (
    ALPHA_MAX,
    ALPHA_THRESHOLD,
    CASC_BATCH,
    T_THRESHOLD,
    TAIL_BATCH,
    TILE_X,
    TILE_Y,
)
from ..ops.stopthepop import (
    depth_along_ray,
    max_contrib_power_rect,
    per_tile_depth,
    tile_rect_bounds,
)
from ..ops.transforms import compute_view_ray
from .preprocess import PreprocessOutput

INF = float("inf")


def _pixel_grid(width: int, height: int, device=None):
    """[H*W, 2] pixel coordinates (x, y), row-major like the reference."""
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=device),
        torch.arange(width, dtype=torch.float32, device=device),
        indexing="ij")
    return torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1)


def _pixel_tiles(pix, tile=(TILE_X, TILE_Y)):
    """[N, 2] int32 coordinates (tx, ty) of the pixels' binning tiles of
    ``tile`` = (tile_x, tile_y) pixels (those ``prep``'s rects count)."""
    return torch.stack(
        [torch.div(pix[:, 0], tile[0], rounding_mode="floor"),
         torch.div(pix[:, 1], tile[1], rounding_mode="floor")],
        dim=-1).to(torch.int32)


def _in_rect(rect_min, rect_max, pix_tile):
    """[P, N] bool: each Gaussian's tile rect covers each pixel's tile."""
    tx, ty = pix_tile[None, :, 0], pix_tile[None, :, 1]
    return ((tx >= rect_min[:, None, 0]) & (tx < rect_max[:, None, 0])
            & (ty >= rect_min[:, None, 1]) & (ty < rect_max[:, None, 1]))


def _covers(prep: PreprocessOutput, pix_tile):
    """[P, N] bool: the Gaussian is valid and its tile rect covers the
    pixel's tile (the tiled renderers' pair stream)."""
    return (_in_rect(prep.rect_min, prep.rect_max, pix_tile)
            & prep.valid[:, None])


def _tile_culled(prep: PreprocessOutput, pix_tile):
    """[P, N] bool: tile-based culling drops the pair (the Gaussian's least
    power over the pixel's tile exceeds its opacity threshold)."""
    tile_min, tile_max = tile_rect_bounds(pix_tile[None, :, 0],
                                          pix_tile[None, :, 1])
    power, _ = max_contrib_power_rect(
        prep.conic_opacity[:, None, :], prep.mean2d[:, None, :],
        tile_min, tile_max)
    return power > prep.opacity_power_threshold[:, None]


def _alpha(conic_opacity, mean2d, pix):
    """Alpha of every Gaussian at every pixel, and where it is skipped.

    conic_opacity [G, 4], mean2d [G, 2], pix [N, 2] -> (alpha [G, N], skip
    [G, N]): power < 0 or alpha < 1/255 skip; alpha clamps at 0.99
    (forward.cu:312-325).
    """
    d = mean2d[:, None, :] - pix[None, :, :]
    a, b, c, opw = (conic_opacity[:, i:i + 1] for i in range(4))
    factor = (0.5 * (a * d[..., 0] ** 2 + c * d[..., 1] ** 2)
              + b * d[..., 0] * d[..., 1])
    alpha = torch.clamp(opw * torch.exp(-factor), max=ALPHA_MAX)
    skip = (factor < 0.0) | (alpha < ALPHA_THRESHOLD)
    return alpha, skip


def blend_prefix(alpha_eff, feats, T_carry=None, C_carry=None,
                 idx_carry=None, base_index=1):
    """Blend one front-to-back sorted batch with the masked prefix product.

    alpha_eff [G, N] (0 where skipped); feats [G, N, C], or [G, C] for
    colours that do not depend on the pixel. The carries come from earlier
    batches (default: T 1, C 0, idx 0); ``base_index`` is the 1-based
    position of the batch's first entry. Returns (T [N], C [N, C], idx [N]
    int32): T the last committed U, idx the position of the last committed
    entry with alpha > 0.
    """
    G, N = alpha_eff.shape
    dev = alpha_eff.device
    if T_carry is None:
        T_carry = torch.ones((N,), dtype=torch.float32, device=dev)
        C_carry = torch.zeros((N, feats.shape[-1]), dtype=torch.float32,
                              device=dev)
        idx_carry = torch.zeros((N,), dtype=torch.int32, device=dev)
    U = T_carry[None, :] * torch.exp(torch.cumsum(torch.log1p(-alpha_eff),
                                                  dim=0))  # inclusive
    T_before = torch.cat([T_carry[None, :], U[:-1]], dim=0)
    commit = U >= T_THRESHOLD
    w = alpha_eff * T_before * commit
    if feats.dim() == 2:
        C = C_carry + torch.einsum("gn,gc->nc", w, feats)
    else:
        C = C_carry + torch.einsum("gn,gnc->nc", w, feats)
    U_committed = torch.where(commit, U, torch.full_like(U, INF))
    T = torch.minimum(T_carry, U_committed.min(dim=0).values)
    pos = torch.arange(base_index, base_index + G, dtype=torch.int32,
                       device=dev)
    contributed = commit & (alpha_eff > 0.0)
    idx = torch.maximum(
        idx_carry, torch.where(contributed, pos[:, None], 0).max(dim=0).values)
    return T, C, idx.to(torch.int32)


def _finalize(C, T, bg, width: int, height: int):
    """C + T * bg, laid out [3, H, W] like the reference."""
    img = C + T[:, None] * bg[None, :]
    return img.reshape(height, width, 3).permute(2, 0, 1)


def render_global_naive(prep: PreprocessOutput, bg, width: int, height: int,
                        chunk: int = 256):
    """GLOBAL sort-mode oracle: one global depth order for all pixels.

    Pixels only see Gaussians whose tile rect covers their tile (the tiled
    renderer's visibility). The sorted stream is blended in chunks of
    ``chunk`` entries, each carrying T, C and idx into the next, as the JAX
    oracle's scan does. Returns (color [3, H, W], final_T [H*W], n_contrib
    [H*W]).
    """
    dev = prep.mean2d.device
    P = prep.mean2d.shape[0]
    N = width * height
    pix = _pixel_grid(width, height, dev)
    pix_tile = _pixel_tiles(pix)
    order = torch.sort(torch.where(prep.valid, prep.depth.detach(),
                                   torch.full_like(prep.depth, INF)),
                       stable=True).indices
    T = torch.ones((N,), dtype=torch.float32, device=dev)
    C = torch.zeros((N, 3), dtype=torch.float32, device=dev)
    idx = torch.zeros((N,), dtype=torch.int32, device=dev)
    for start in range(0, P, chunk):
        g = order[start:start + chunk]
        alpha, skip = _alpha(prep.conic_opacity[g], prep.mean2d[g], pix)
        drop = (skip | ~_in_rect(prep.rect_min[g], prep.rect_max[g], pix_tile)
                | ~prep.valid[g][:, None])
        alpha_eff = torch.where(drop, torch.zeros_like(alpha), alpha)
        T, C, idx = blend_prefix(alpha_eff, prep.rgb[g], T, C, idx,
                                 start + 1)
    return _finalize(C, T, bg, width, height), T, idx


def render_full_sort_naive(prep: PreprocessOutput, bg, width: int,
                           height: int, campos, inverse_vp,
                           tile=(TILE_X, TILE_Y)):
    """PER_PIXEL_FULL oracle: every pixel sorts all Gaussians by exact depth
    along its ray and blends them front to back.

    A Gaussian counts at a pixel where its rect covers the pixel's tile, it
    is valid, it passes the alpha tests and its ray depth is >= 0
    (resorted_render.cuh:182-184); the sort is stable, so exact ties keep
    Gaussian order. Differentiable through alpha and rgb; the depth channel
    and the order are not. ``tile`` is the binning tile ``prep`` was made
    for. Returns (color [3, H, W], final_T [H*W],
    n_contrib [H*W] int32 (1-based rank of the last committed entry),
    depth_acc [H, W] (sum of w * ray depth)).
    """
    dev = prep.mean2d.device
    pix = _pixel_grid(width, height, dev)
    viewdir = compute_view_ray(pix, width, height, inverse_vp, campos)
    depth = depth_along_ray(prep.cov3d_inv9[:, None, :], viewdir[None, :, :])

    alpha, skip = _alpha(prep.conic_opacity, prep.mean2d, pix)
    drop = skip | ~_covers(prep, _pixel_tiles(pix, tile)) | (depth < 0.0)
    alpha_eff = torch.where(drop, torch.zeros_like(alpha), alpha)

    key = torch.where(alpha_eff > 0.0, depth.detach(),
                      torch.full_like(alpha, INF))
    order = torch.sort(key, dim=0, stable=True).indices  # [P, N]
    alpha_sorted = torch.gather(alpha_eff, 0, order)
    depth_sorted = torch.gather(depth.detach(), 0, order)
    rgb_sorted = prep.rgb[order]  # [P, N, 3]

    # The 4th channel accumulates w * ray depth (the Depth visualization).
    feats = torch.cat([rgb_sorted, depth_sorted[..., None]], dim=-1)
    T, C, idx = blend_prefix(alpha_sorted, feats)
    return (_finalize(C[:, :3], T, bg, width, height), T, idx,
            C[:, 3].reshape(height, width))


# ---------------------------------------------------------------------------
# Sort error and the PER_PIXEL_KBUFFER oracle
# ---------------------------------------------------------------------------
#
# The k-buffer resort (the reference's renderkBufferCUDA,
# resorted_render.cuh:17-221): per pixel, a K-entry window sorted ascending
# by exact per-ray depth consumes the pixel's tile stream in stream order,
# one entry at a time: an alpha-culled entry (factor < 0, alpha < 1/255) or
# one with ray depth < 0 is skipped; when the window is full its front
# (nearest) entry pops and blends front to back (a commit only while the
# transmittance stays >= 1e-4; a failed commit latches `done`); the entry
# is inserted at its sorted place. At stream end the window drains.


def _init_sort_error(N: int, device):
    """(running max of committed depths, opacity error, distance error)."""
    return (torch.full((N,), -INF, device=device),
            torch.zeros((N,), device=device), torch.zeros((N,), device=device))


def _accum_sort_error(serr, commit, alpha, depth):
    """The reference's sort-error accumulation (stopthepop_common.cuh:
    264-282): a committed contribution whose per-ray depth is at or below
    the running max of earlier committed depths adds its opacity (resp. the
    depth gap) to the pixel's error. Ties count as out of order, as the
    reference's ``depth <= currentMaxDepth``. ``serr`` = (dmax, eop, edist),
    all [N]; None passes through."""
    if serr is None:
        return None
    dmax, eop, edist = serr
    real = commit & (alpha > 0.0)
    ooo = real & (depth <= dmax)
    eop = eop + torch.where(ooo, alpha, 0.0)
    edist = edist + torch.where(ooo, dmax - depth, 0.0)
    dmax = torch.where(real, torch.maximum(dmax, depth), dmax)
    return dmax, eop, edist


def _shift_front(x, m, pad):
    """Drop row 0 of [K, N] ``x`` where ``m``, shifting the rest forward."""
    shifted = torch.cat([x[1:], torch.full_like(x[:1], pad)], dim=0)
    return torch.where(m[None, :], shifted, x)


def _insert_sorted(keys, new_key, v):
    """Rows of a sorted [K, N] window and where to put an entry with key
    ``new_key`` [N] (after any equal keys), where ``v``: returns a function
    inserting a field's new value."""
    K = keys.shape[0]
    pos = (keys <= new_key[None, :]).sum(dim=0)
    ik = torch.arange(K, device=keys.device)[:, None]

    def ins(x, nv):
        shifted = torch.cat([x[:1], x[:-1]], dim=0)
        at = torch.where(ik == pos[None, :], nv[None, :], shifted)
        out = torch.where(ik < pos[None, :], x, at)
        return torch.where(v[None, :], out, x)

    return ins


_MID_FIELDS = ("dh", "a", "r", "g", "b")
_HEAD_FIELDS = ("a", "r", "g", "b")
_TAIL_FIELDS = ("dm", "dh", "a", "r", "g", "b")


def _hwin_shift(win, m):
    return {f: _shift_front(v, m, INF if f == "key" else 0.0)
            for f, v in win.items()}


def _hwin_insert(win, v, new):
    ins = _insert_sorted(win["key"], new["key"], v)
    return {f: ins(win[f], new[f]) for f in win}


def _blend_one(T, C, nc, done, popm, a0, rgb0, count_zero_alpha=True):
    """Blend one popped entry where ``popm``; returns (T, C, nc, done,
    commit). ``nc`` counts every commit, or with ``count_zero_alpha``
    False only those of alpha > 0 (the HIER cascade's count)."""
    U = T * (1.0 - a0)
    commit = popm & ~done & (U >= T_THRESHOLD)
    done = done | (popm & (U < T_THRESHOLD))
    w = torch.where(commit, a0 * T, 0.0)
    C = C + w[:, None] * rgb0
    T = torch.where(commit, U, T)
    counted = commit if count_zero_alpha else commit & (a0 > 0.0)
    nc = nc + counted.to(nc.dtype)
    return T, C, nc, done, commit


def pair_stream_keys(prep: PreprocessOutput, pix_tile, sort_order, campos,
                     inverse_vp, w: int, h: int, tile=(TILE_X, TILE_Y)):
    """Per-(Gaussian, pixel) stream sort key [P, N] for the pixel's
    binning tile of ``tile`` = (tile_x, tile_y) pixels."""
    P, N = prep.depth.shape[0], pix_tile.shape[0]
    sort_order = GlobalSortOrder(sort_order)
    if sort_order in (GlobalSortOrder.Z_DEPTH, GlobalSortOrder.DISTANCE):
        return prep.depth[:, None].expand(P, N)
    tx, ty = pix_tile[None, :, 0], pix_tile[None, :, 1]
    if sort_order == GlobalSortOrder.PTD_CENTER:
        target = torch.stack(
            [tx.to(torch.float32) * tile[0] + (tile[0] - 1) / 2.0,
             ty.to(torch.float32) * tile[1] + (tile[1] - 1) / 2.0],
            dim=-1).expand(P, N, 2)
    else:  # PTD_MAX
        tile_min, tile_max = tile_rect_bounds(tx, ty, *tile)
        _, target = max_contrib_power_rect(
            prep.conic_opacity[:, None, :], prep.mean2d[:, None, :],
            tile_min, tile_max, patch_w=tile[0] - 1, patch_h=tile[1] - 1)
    return per_tile_depth(target, prep.cov3d_inv9[:, None, :], campos, w, h,
                          inverse_vp)


def render_global_order_naive(prep: PreprocessOutput, bg, width: int,
                              height: int, campos, inverse_vp,
                              sort_order=GlobalSortOrder.PTD_CENTER,
                              tile_based_culling: bool = False):
    """GLOBAL sort-mode oracle under any stream order, per-tile keys
    included (PTD_CENTER / PTD_MAX): every pixel blends its tile's pairs in
    ascending per-tile stream key with no resort window. Dense [P, N].

    Returns (color [3, H, W], final_T [N], n_contrib [N]). Its sort-error
    maps are ``render/debug_viz.py::sort_error_maps``.
    """
    dev = prep.mean2d.device
    pix = _pixel_grid(width, height, dev)
    pix_tile = _pixel_tiles(pix)
    alpha, skip = _alpha(prep.conic_opacity, prep.mean2d, pix)
    stream_valid = _covers(prep, pix_tile)
    if tile_based_culling:
        stream_valid = stream_valid & ~_tile_culled(prep, pix_tile)
    alpha_eff = torch.where(skip | ~stream_valid, torch.zeros_like(alpha),
                            alpha)
    key = pair_stream_keys(prep, pix_tile, sort_order, campos, inverse_vp,
                           width, height).detach()
    key = torch.where(stream_valid, key, torch.full_like(key, INF))
    order = torch.sort(key, dim=0, stable=True).indices
    T, C, idx = blend_prefix(torch.gather(alpha_eff, 0, order),
                             prep.rgb[order])
    return _finalize(C, T, bg, width, height), T, idx


def render_kbuffer_naive(prep: PreprocessOutput, bg, width: int, height: int,
                         campos, inverse_vp, k: int = 4,
                         sort_order=GlobalSortOrder.Z_DEPTH,
                         tile_based_culling: bool = False,
                         sort_error: bool = False):
    """PER_PIXEL_KBUFFER oracle. Returns (color [3,H,W], final_T, n_contrib);
    with ``sort_error=True`` additionally (err_opacity [H,W],
    err_distance [H,W]): the reference's out-of-order blending measure
    accumulated in this mode's pop order."""
    dev = prep.mean2d.device
    N = width * height
    pix = _pixel_grid(width, height, dev)
    pix_tile = _pixel_tiles(pix)
    viewdir = compute_view_ray(pix, width, height, inverse_vp, campos)
    ray_depth = depth_along_ray(prep.cov3d_inv9[:, None, :],
                                viewdir[None, :, :]).detach()
    alpha, skip = _alpha(prep.conic_opacity, prep.mean2d, pix)
    drop = skip | ~_covers(prep, pix_tile) | (ray_depth < 0.0)
    if tile_based_culling:
        drop = drop | _tile_culled(prep, pix_tile)
    alpha_eff = torch.where(drop, torch.zeros_like(alpha), alpha)

    key = pair_stream_keys(prep, pix_tile, sort_order, campos, inverse_vp,
                           width, height).detach()
    key = torch.where(alpha_eff > 0.0, key, torch.full_like(key, INF))
    order = torch.sort(key, dim=0, stable=True).indices  # [P, N]
    alpha_s = torch.gather(alpha_eff, 0, order)
    depth_s = torch.gather(ray_depth, 0, order)
    rgb_s = prep.rgb[order]  # [P, N, 3]

    win = {"key": torch.full((k, N), INF, device=dev)}
    win.update({f: torch.zeros((k, N), device=dev) for f in _HEAD_FIELDS})
    fill = torch.zeros((N,), dtype=torch.int32, device=dev)
    T = torch.ones((N,), device=dev)
    C = torch.zeros((N, 3), device=dev)
    nc = torch.zeros((N,), dtype=torch.int32, device=dev)
    done = torch.zeros((N,), dtype=torch.bool, device=dev)
    serr = _init_sort_error(N, dev)

    def pop(popm, win, fill, T, C, nc, done, serr):
        T, C, nc, done, commit = _blend_one(
            T, C, nc, done, popm, win["a"][0],
            torch.stack([win[f][0] for f in "rgb"], dim=-1))
        serr = _accum_sort_error(serr, commit, win["a"][0], win["key"][0])
        return (_hwin_shift(win, popm), fill - popm.to(fill.dtype), T, C, nc,
                done, serr)

    for i in range(alpha_s.shape[0]):
        v = alpha_s[i] > 0.0
        win, fill, T, C, nc, done, serr = pop(
            (fill == k) & v, win, fill, T, C, nc, done, serr)
        win = _hwin_insert(win, v, {
            "key": depth_s[i], "a": alpha_s[i], "r": rgb_s[i, :, 0],
            "g": rgb_s[i, :, 1], "b": rgb_s[i, :, 2]})
        fill = fill + v.to(fill.dtype)
    for _ in range(k):
        win, fill, T, C, nc, done, serr = pop(
            fill > 0, win, fill, T, C, nc, done, serr)
    out = (_finalize(C, T, bg, width, height), T, nc)
    if sort_error:
        out = out + (serr[1].reshape(height, width),
                     serr[2].reshape(height, width))
    return out


# ---------------------------------------------------------------------------
# HIERARCHICAL oracle
# ---------------------------------------------------------------------------
#
# The paper's hierarchical resorting renderer (hierarchical_render.cuh:
# 207-1035) as an element-at-a-time cascade with the JAX oracle's queue
# semantics: a tail of tile_4x4 entries per 4x4 sub-tile, consumed in
# sorted batches of TAIL_BATCH by the sub-tile-centre ray depth; a mid
# window of tile_2x2 entries per 2x2 quad, keyed by the quad-centre ray
# depth; a head window of per_pixel entries per pixel, keyed by the pixel's
# own ray depth. A full window that receives an entry pops its front to the
# next level; a head pop is the blend. Tile-based culling gates the stream,
# hierarchical 4x4 culling drops entries whose least power over the
# sub-tile exceeds the opacity threshold, entries with a negative sub-tile
# depth are dropped at tail entry, and per-pixel alpha masking happens at
# blend time (entries ride through with alpha 0).

def subtile_center(pix):
    """Centre pixel coordinate of the 4x4 sub-tile containing each pixel."""
    return torch.floor(pix / 4.0) * 4.0 + 1.5


def quad_center(pix):
    """Centre pixel coordinate of the 2x2 quad containing each pixel."""
    return torch.floor(pix / 2.0) * 2.0 + 0.5


def _batched_cascade(stream, hold, empty, queue_sizes, N, dev):
    """The batched cascade of ``render_hierarchical_naive``: (T, C, nc).

    Each tail round's 64 emitted entries enter the mid window keyed by
    d_mid where their tail key is finite; ghosts and drain pads get -inf and
    alpha 0. They go in sub-batches of ``CASC_BATCH``: the hold (``km``
    entries, ascending, first all -inf "bubbles") and the sub-batch are
    sorted stably (hold first, then the sub-batch in order); the first
    ``CASC_BATCH`` are emitted and the last ``km`` kept. The emitted
    entries, keyed by d_head where their mid key is finite (else that key),
    run the same round through the head window (``kh``), and its emitted
    entries are blended in order. After the tail's drain, ``ceil(km / 8)``
    mid rounds of +inf pads, then the head hold blended in place."""
    kt, km, kh = queue_sizes
    B, Bc = TAIL_BATCH, CASC_BATCH
    mid, head = empty(km, _MID_FIELDS, -INF), empty(kh, _HEAD_FIELDS, -INF)
    s = {"T": torch.ones((N,), device=dev), "C": torch.zeros((N, 3), device=dev),
         "nc": torch.zeros((N,), dtype=torch.int32, device=dev),
         "done": torch.zeros((N,), dtype=torch.bool, device=dev)}
    every = torch.ones((N,), dtype=torch.bool, device=dev)

    def win_round(win, batch):
        cat = {f: torch.cat([win[f], batch[f]], dim=0) for f in win}
        o = torch.sort(cat["key"], dim=0, stable=True).indices
        srt = {f: torch.gather(v, 0, o) for f, v in cat.items()}
        return ({f: v[:Bc] for f, v in srt.items()},
                {f: v[Bc:] for f, v in srt.items()})

    def blend(rows):
        for j in range(rows["a"].shape[0]):
            s["T"], s["C"], s["nc"], s["done"], _ = _blend_one(
                s["T"], s["C"], s["nc"], s["done"], every, rows["a"][j],
                torch.stack([rows[f][j] for f in "rgb"], dim=-1),
                count_zero_alpha=False)

    def mid_round(mid, head, batch):
        emit_m, mid = win_round(mid, batch)
        key_h = torch.where(torch.isfinite(emit_m["key"]), emit_m["dh"],
                            emit_m["key"])
        emit_h, head = win_round(head, {"key": key_h, **{
            f: emit_m[f] for f in _HEAD_FIELDS}})
        blend(emit_h)
        return mid, head

    def tail_batch(hold, mid, head, batch):
        cat = {f: torch.cat([hold[f], batch[f]], dim=0) for f in hold}
        o = torch.sort(cat["key"], dim=0, stable=True).indices
        srt = {f: torch.gather(v, 0, o) for f, v in cat.items()}
        v = torch.isfinite(srt["key"][:B])
        into_mid = {"key": torch.where(v, srt["dm"][:B], -INF),
                    "a": torch.where(v, srt["a"][:B], 0.0),
                    **{f: srt[f][:B] for f in ("dh", "r", "g", "b")}}
        for sb in range(0, B, Bc):
            mid, head = mid_round(mid, head, {f: x[sb:sb + Bc]
                                              for f, x in into_mid.items()})
        return {f: x[B:] for f, x in srt.items()}, mid, head

    for start in range(0, stream["key"].shape[0], B):
        batch = {f: v[start:start + B] for f, v in stream.items()}
        hold, mid, head = tail_batch(hold, mid, head, batch)
    drain = empty(B, _TAIL_FIELDS, INF)
    for _ in range(-(-kt // B)):
        hold, mid, head = tail_batch(hold, mid, head, drain)
    for _ in range(-(-km // Bc)):
        mid, head = mid_round(mid, head, empty(Bc, _MID_FIELDS, INF))
    blend(head)
    return s["T"], s["C"], s["nc"]


def render_hierarchical_naive(prep: PreprocessOutput, bg, width: int,
                              height: int, campos, inverse_vp,
                              queue_sizes=(64, 8, 4),
                              sort_order=GlobalSortOrder.Z_DEPTH,
                              tile_based_culling: bool = False,
                              hier_4x4_culling: bool = False,
                              batched_cascade: bool = False,
                              sort_error: bool = False):
    """HIERARCHICAL oracle. Returns (color [3,H,W], final_T, n_contrib);
    ``sort_error=True`` (per-entry cascade only) appends the reference's
    (err_opacity, err_distance) [H,W] maps accumulated in head-pop order.

    ``batched_cascade`` moves the tail's emitted entries through the mid and
    head windows in sorted sub-batches of ``CASC_BATCH`` (``_batched_cascade``)
    instead of one pop-then-insert step per entry."""
    if batched_cascade and sort_error:
        raise NotImplementedError(
            "sort_error maps: per-entry cascade only (batched_cascade=True)")
    kt, km, kh = queue_sizes
    dev = prep.mean2d.device
    N = width * height
    pix = _pixel_grid(width, height, dev)
    pix_tile = _pixel_tiles(pix)

    def ray_depth(target_pix):
        vd = compute_view_ray(target_pix, width, height, inverse_vp, campos)
        return depth_along_ray(prep.cov3d_inv9[:, None, :],
                               vd[None, :, :]).detach()

    d_head = ray_depth(pix)                   # [P, N]
    d_mid = ray_depth(quad_center(pix))
    d_tail = ray_depth(subtile_center(pix))

    alpha, skip = _alpha(prep.conic_opacity, prep.mean2d, pix)
    stream_valid = _covers(prep, pix_tile)
    if tile_based_culling:
        stream_valid = stream_valid & ~_tile_culled(prep, pix_tile)
    a_eff = torch.where(skip | ~stream_valid | (d_head < 0.0),
                        torch.zeros_like(alpha), alpha)
    v_tail = stream_valid & (d_tail >= 0.0)
    if hier_4x4_culling:
        st_min = torch.floor(pix / 4.0) * 4.0  # [N, 2]
        power4, _ = max_contrib_power_rect(
            prep.conic_opacity[:, None, :], prep.mean2d[:, None, :],
            st_min[None], st_min[None] + 3.0, patch_w=3, patch_h=3)
        v_tail = v_tail & (power4 <= prep.opacity_power_threshold[:, None])

    key = pair_stream_keys(prep, pix_tile, sort_order, campos, inverse_vp,
                           width, height).detach()
    key = torch.where(stream_valid, key, torch.full_like(key, INF))
    order = torch.sort(key, dim=0, stable=True).indices

    def sort_by(x):
        return torch.gather(x, 0, order)

    rgb_s = prep.rgb[order]  # [P, N, 3]
    # The tail consumes the stream in sorted batches of TAIL_BATCH: per
    # batch, sort(hold ++ incoming) by the sub-tile key and emit the first
    # TAIL_BATCH rows (nearest) into the mid/head cascade, holding the
    # farthest kt. Invalid incoming entries carry a -inf key ("ghosts") and
    # the initial hold is -inf "bubbles": both sort to the emission's front
    # and are masked at mid entry.
    B = TAIL_BATCH
    P = order.shape[0]
    pad = (-P) % B

    def padB(x, fill=0.0):
        if not pad:
            return x
        return torch.cat([x, torch.full((pad, N), fill, device=dev)])

    stream = {"key": padB(torch.where(sort_by(v_tail), sort_by(d_tail),
                                      torch.full_like(d_tail, -INF)), -INF),
              "dm": padB(sort_by(d_mid)), "dh": padB(sort_by(d_head)),
              "a": padB(sort_by(a_eff)), "r": padB(rgb_s[..., 0]),
              "g": padB(rgb_s[..., 1]), "b": padB(rgb_s[..., 2])}

    def empty(k, fields, key_fill):
        w = {"key": torch.full((k, N), key_fill, device=dev)}
        w.update({f: torch.zeros((k, N), device=dev) for f in fields})
        return w

    hold = empty(kt, _TAIL_FIELDS, -INF)
    if batched_cascade:
        T, C, nc = _batched_cascade(stream, hold, empty, queue_sizes, N, dev)
        return _finalize(C, T, bg, width, height), T, nc
    mid = empty(km, _MID_FIELDS, INF)
    head = empty(kh, _HEAD_FIELDS, INF)
    zi = torch.zeros((N,), dtype=torch.int32, device=dev)
    s = {"fm": zi, "fh": zi, "T": torch.ones((N,), device=dev),
         "C": torch.zeros((N, 3), device=dev), "nc": zi,
         "done": torch.zeros((N,), dtype=torch.bool, device=dev),
         "serr": _init_sort_error(N, dev)}

    def pop_head(head, pop_h):
        e = {f: v[0] for f, v in head.items()}
        s["T"], s["C"], s["nc"], s["done"], commit = _blend_one(
            s["T"], s["C"], s["nc"], s["done"], pop_h, e["a"],
            torch.stack([e["r"], e["g"], e["b"]], dim=-1),
            count_zero_alpha=False)
        s["serr"] = _accum_sort_error(s["serr"], commit, e["a"], e["key"])
        s["fh"] = s["fh"] - pop_h.to(torch.int32)
        return _hwin_shift(head, pop_h)

    def push_head(mid, head, pop_m):
        e_m = {f: v[0] for f, v in mid.items()}
        head = pop_head(head, pop_m & (s["fh"] == kh))
        head = _hwin_insert(head, pop_m, {"key": e_m["dh"], "a": e_m["a"],
                                          "r": e_m["r"], "g": e_m["g"],
                                          "b": e_m["b"]})
        s["fh"] = s["fh"] + pop_m.to(torch.int32)
        return head

    def cascade_entry(mid, head, e):
        v = torch.isfinite(e["key"])
        pop_m = v & (s["fm"] == km)
        head = push_head(mid, head, pop_m)
        mid = _hwin_shift(mid, pop_m)
        mid = _hwin_insert(mid, v, {"key": e["dm"], **{f: e[f] for f in
                                                       _MID_FIELDS}})
        s["fm"] = s["fm"] - pop_m.to(torch.int32) + v.to(torch.int32)
        return mid, head

    def tail_batch(hold, mid, head, batch):
        cat = {f: torch.cat([hold[f], batch[f]], dim=0) for f in hold}
        o = torch.sort(cat["key"], dim=0, stable=True).indices
        srt = {f: torch.gather(v, 0, o) for f, v in cat.items()}
        for j in range(B):
            mid, head = cascade_entry(mid, head,
                                      {f: v[j] for f, v in srt.items()})
        return {f: v[B:] for f, v in srt.items()}, mid, head

    for start in range(0, P + pad, B):
        batch = {f: v[start:start + B] for f, v in stream.items()}
        hold, mid, head = tail_batch(hold, mid, head, batch)
    # Tail drain: +inf incoming pads push every held real entry out.
    drain = empty(B, _TAIL_FIELDS, INF)
    for _ in range(-(-kt // B)):
        hold, mid, head = tail_batch(hold, mid, head, drain)
    for _ in range(km):
        pop_m = s["fm"] > 0
        head = push_head(mid, head, pop_m)
        mid = _hwin_shift(mid, pop_m)
        s["fm"] = s["fm"] - pop_m.to(torch.int32)
    for _ in range(kh):
        head = pop_head(head, s["fh"] > 0)

    T, C, nc = s["T"], s["C"], s["nc"]
    out = (_finalize(C, T, bg, width, height), T, nc)
    if sort_error:
        out = out + (s["serr"][1].reshape(height, width),
                     s["serr"][2].reshape(height, width))
    return out
