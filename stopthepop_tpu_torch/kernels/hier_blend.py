"""HIERARCHICAL sort-mode tile blend, forward: the CUDA kernel K5 and its
plain PyTorch version.

K5 replaces ``stopthepop_tpu/kernels/hier_blend.py::blend_hier_forward``
(the Pallas ``_fwd_kernel``, per-entry cascade). Its shape is K1/K3's: one
block of 256 threads per 16x16 tile, batches of the tile's (tile,
depth)-sorted pairs staged in shared memory. The source note
(``csrc/hier_blend_fwd.cu``) says what bounds it on an H100 and how its
design keeps the cascade exact.

Semantics (JAX ``render/naive.py::render_hierarchical_naive`` with
``batched_cascade=False``, the reference's hierarchical renderer,
hierarchical_render.cuh:207-1035). Every pixel reads its tile's sorted pair
stream through three sorted windows:

* tail, one per 4x4 sub-tile, ``kt`` entries, keyed by the depth along the
  ray through the sub-tile center (``floor(p / 4) * 4 + 1.5``). An entry is
  valid for the sub-tile where that depth is >= 0 and, with
  ``hier_4x4_culling``, where its smallest power over the sub-tile rect
  (``max_contrib_power_rect``, patch 3x3) is at most its
  ``opacity_power_threshold``; invalid entries carry the key -inf
  ("ghosts"). The tail consumes the stream in batches of ``TAIL_BATCH`` =
  64 positions: the hold (``kt`` entries, first all -inf) and the batch are
  sorted together, stably (hold first, then the batch in stream order); the
  first 64 are emitted in that order and the last ``kt`` are the new hold.
  After the stream, ``ceil(kt / 64)`` batches of +inf pads push the hold out;
* mid, one per 2x2 quad, ``km`` entries, keyed by the depth along the ray
  through the quad center (``floor(p / 2) * 2 + 0.5``). Every emitted entry
  with a finite key enters; a full window (``fm == km``) first pops its
  front into the head, then the entry goes in behind every entry of equal
  or smaller key;
* head, one per pixel, ``kh`` entries, keyed by the exact depth along the
  pixel's ray through the integer pixel (``d_head``), with the same
  pop-before-insert rule. A head pop is the blend: U = T (1 - a) commits
  where the pixel is not done and U >= 1e-4 (C += w rgb, depth_acc +=
  w d_head with w = a T, T = U), and sets the done latch where U < 1e-4;
  ``n_contrib`` counts the commits with a > 0.

An entry keeps its slot in the mid and head windows of every pixel of its
sub-tile, also where it gives the pixel alpha 0 (power < 0, alpha < 1/255
or d_head < 0): the fill counts and every pop decision are the same for the
16 pixels of a sub-tile. After the tail's drain, ``km`` mid steps pop every
mid entry into the head, then ``kh`` head steps blend what is left.

The wrapper launches K5 for CUDA tensors and runs the plain version for CPU
tensors, and nothing else: on a CUDA tensor it launches the kernel or
raises. The plain version holds the tail of all tiles as [T, 16, kt + 64]
and sorts it with ``torch.sort(stable=True)``, holds the mid and head
windows as [km | kh, T, 256], and repeats K5's arithmetic operation by
operation.

Inputs: the sorted Gaussian ids ``point_list`` [N] int32, ``starts``/``ends``
[T] int32, the per-Gaussian rows ``xy`` [P, 2], ``conic_opacity`` [P, 4],
``rgb`` [P, 3], ``cov3d_inv9`` [P, 9] (packed Sigma^-1 and
u = Sigma^-1 (mean - campos)), ``opacity_power_threshold`` [P]
(log(opacity / alpha threshold)), the camera ``inverse_vp`` [4, 4] and
``campos`` [3] (float32), and the queue sizes (kt, km, kh). Outputs:
color [3, H, W] (raw; the caller composites the background), final_T
[H, W], n_contrib [H, W] int32, depth_acc [H, W].
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..constants import (
    ALPHA_MAX,
    ALPHA_THRESHOLD,
    T_THRESHOLD,
    TAIL_BATCH,
    TILE_PIXELS,
    TILE_X,
    TILE_Y,
)
from ..ops.stopthepop import depth_along_ray, max_contrib_power_rect
from ..ops.transforms import compute_view_ray
from . import build
from .global_blend import _check_inputs, _tile_pixel_coords, pack_image, unpack_image
from .kbuffer_blend import _check_float_rows, _cuda_prelude, _insert, _shift_out

KERNEL = "hier_blend_fwd"
SOURCE = "stopthepop_tpu_torch/csrc/hier_blend_fwd.cu"
REPLACES = "stopthepop_tpu/kernels/hier_blend.py:923"
# K5 is instantiated for the reference's mid and head window sizes
# (SURVEY.md:251-254); a run uses the smallest instantiation that holds its
# runtime sizes. The tail lives in dynamic shared memory, 256 (kt + 64)
# bytes a block, which TAIL_MAX keeps under the H100's 227 KB.
MID_SIZES = (8, 12, 20)
HEAD_SIZES = (4, 8, 16)
TAIL_MAX = 512
SUBTILES = 16


def check_hier_queues(tile_4x4, tile_2x2, per_pixel):
    """The HIER queue sizes (kt, km, kh) as ints, or ValueError outside
    kt in 1..512, km in 1..20, kh in 1..16."""
    out = []
    for name, v, top in (("tile_4x4", tile_4x4, TAIL_MAX),
                         ("tile_2x2", tile_2x2, MID_SIZES[-1]),
                         ("per_pixel", per_pixel, HEAD_SIZES[-1])):
        if isinstance(v, bool) or int(v) != v or not 1 <= v <= top:
            raise ValueError(
                f"HIER queue size SortQueueSizes.{name} must be an integer "
                f"in 1..{top}, got {v!r}")
        out.append(int(v))
    return tuple(out)


def _instance(k: int, sizes) -> int:
    return next(m for m in sizes if m >= k)


@functools.lru_cache(maxsize=None)
def _bind():
    lib = build.load(KERNEL)
    fn = lib.stp_hier_blend_fwd
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_float] * 2
                   + [ctypes.c_int] * 10 + [ctypes.c_void_p] * 5)
    fn.restype = ctypes.c_int
    return fn


def _check_hier_inputs(point_list, starts, ends, xy, conic_opacity, rgb,
                       cov3d_inv9, opacity_power_threshold, inverse_vp,
                       campos, grid_x, grid_y, width, height):
    _check_inputs(point_list, starts, ends, xy, conic_opacity, rgb, None,
                  grid_x, grid_y, width, height)
    P = xy.shape[0]
    _check_float_rows(xy, {
        "cov3d_inv9": (cov3d_inv9, (P, 9)),
        "opacity_power_threshold": (opacity_power_threshold, (P,)),
        "inverse_vp": (inverse_vp, (4, 4)), "campos": (campos, (3,))})


def blend_hier_forward(point_list, starts, ends, xy, conic_opacity, rgb,
                       cov3d_inv9, opacity_power_threshold, inverse_vp, campos,
                       *, queue_sizes, hier_4x4_culling: bool, grid_x: int,
                       grid_y: int, width: int, height: int):
    """HIERARCHICAL blend of every tile's sorted segment (kernel K5).

    Returns (color [3, H, W] raw, final_T [H, W], n_contrib [H, W] int32,
    depth_acc [H, W]). CUDA tensors go to kernel K5 (counted in
    ``blend_hier_forward.launches``); CPU tensors to the plain version.
    """
    kt, km, kh = check_hier_queues(*queue_sizes)
    _check_hier_inputs(point_list, starts, ends, xy, conic_opacity, rgb,
                       cov3d_inv9, opacity_power_threshold, inverse_vp, campos,
                       grid_x, grid_y, width, height)
    dev = xy.device
    if dev.type == "cpu":
        return blend_hier_forward_plain(
            point_list, starts, ends, xy, conic_opacity, rgb, cov3d_inv9,
            opacity_power_threshold, inverse_vp, campos,
            queue_sizes=(kt, km, kh), hier_4x4_culling=hier_4x4_culling,
            grid_x=grid_x, grid_y=grid_y, width=width, height=height,
        )
    cam, sx, sy = _cuda_prelude(xy, conic_opacity, inverse_vp, campos, width,
                                height)
    fn = _bind()
    color = torch.empty((3, height, width), dtype=torch.float32, device=dev)
    final_t = torch.empty((height, width), dtype=torch.float32, device=dev)
    n_contrib = torch.empty((height, width), dtype=torch.int32, device=dev)
    depth_acc = torch.empty((height, width), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(
        point_list.data_ptr(), starts.data_ptr(), ends.data_ptr(),
        xy.data_ptr(), conic_opacity.data_ptr(), rgb.data_ptr(),
        cov3d_inv9.data_ptr(), opacity_power_threshold.data_ptr(),
        cam.data_ptr(), sx, sy, kt, km, kh,
        _instance(km, MID_SIZES), _instance(kh, HEAD_SIZES),
        int(bool(hier_4x4_culling)), grid_x, grid_y, width, height,
        color.data_ptr(), final_t.data_ptr(), n_contrib.data_ptr(),
        depth_acc.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"{KERNEL} launch failed: cudaError_t {err}")
    blend_hier_forward.launches += 1
    return color, final_t, n_contrib, depth_acc


blend_hier_forward.launches = 0


def subtile_of_pixel(device):
    """[256] sub-tile (row-major 4x4 grid of 4x4 pixels) of each pixel of a
    tile, pixels row-major."""
    j = torch.arange(TILE_PIXELS, device=device)
    return (j // (4 * TILE_X)) * 4 + (j % TILE_X) // 4


def blend_hier_forward_plain(point_list, starts, ends, xy, conic_opacity, rgb,
                             cov3d_inv9, opacity_power_threshold, inverse_vp,
                             campos, *, queue_sizes, hier_4x4_culling: bool,
                             grid_x: int, grid_y: int, width: int, height: int,
                             count_evaluations: bool = False):
    """Plain PyTorch version of kernel K5, same signature and outputs.

    With ``count_evaluations`` it also returns a dict of what K5 does on
    these inputs (a tile stops once every pixel of it is done):
    ``tail_keys`` (sub-tile keys of stream positions), ``tail_slots``
    (entries placed by the tail merges), ``evaluations`` (per-pixel
    recomputes of an emitted entry: alpha and the head ray depth),
    ``mid_inserts`` (per-quad entries of an emitted entry: the quad-center
    ray depth and the mid insert, the same for the 4 pixels of a quad),
    ``head_inserts`` (per-pixel mid pops) and ``commits`` (those with
    a > 0, the sum of n_contrib).
    """
    kt, km, kh = check_hier_queues(*queue_sizes)
    dev = xy.device
    T_tiles = grid_x * grid_y
    n = {"tail_keys": 0, "tail_slots": 0, "evaluations": 0,
         "mid_inserts": 0, "head_inserts": 0, "commits": 0}
    if point_list.numel() == 0:  # nothing enters any window
        img = torch.zeros((height, width), dtype=torch.float32, device=dev)
        out = (torch.zeros((3, height, width), dtype=torch.float32,
                           device=dev), img + 1.0,
               torch.zeros((height, width), dtype=torch.int32, device=dev), img)
        return out + (n,) if count_evaluations else out
    B = TAIL_BATCH
    counts = (ends - starts).to(torch.int64)
    starts64 = starts.to(torch.int64)
    max_count = int(counts.max()) if T_tiles else 0
    inf = float("inf")

    def rays(fx, fy):
        return compute_view_ray(torch.stack([fx, fy], dim=-1), width, height,
                                inverse_vp, campos)

    pix_x, pix_y = _tile_pixel_coords(grid_x, grid_y, dev)        # [T, 256]
    vd_head = rays(pix_x, pix_y)
    vd_mid = rays(torch.floor(pix_x / 2.0) * 2.0 + 0.5,
                  torch.floor(pix_y / 2.0) * 2.0 + 0.5)
    tiles = torch.arange(T_tiles, device=dev)[:, None]
    sub = torch.arange(SUBTILES, device=dev)[None, :]
    st_min = torch.stack([(tiles % grid_x) * TILE_X + (sub % 4) * 4,
                          (tiles // grid_x) * TILE_Y + (sub // 4) * 4],
                         dim=-1).to(torch.float32)                # [T, 16, 2]
    vd_tail = rays(st_min[..., 0] + 1.5, st_min[..., 1] + 1.5)    # [T, 16, 3]
    sub_of_pix = subtile_of_pixel(dev)

    shape = (T_tiles, TILE_PIXELS)

    def window(k, fields):
        w = {"d": torch.full((k, *shape), inf, dtype=torch.float32, device=dev)}
        for f in fields:
            w[f] = torch.zeros((k, *shape), dtype=torch.float32, device=dev)
        w["g"] = torch.zeros((k, *shape), dtype=torch.int64, device=dev)
        return w

    st = {
        "mid": window(km, ("dh", "a")),   # key d_mid, then d_head, a, gid
        "head": window(kh, ("a",)),       # key d_head, then a, gid
        "fm": torch.zeros(shape, dtype=torch.int64, device=dev),
        "fh": torch.zeros(shape, dtype=torch.int64, device=dev),
        "T": torch.ones(shape, dtype=torch.float32, device=dev),
        "C": torch.zeros((3, *shape), dtype=torch.float32, device=dev),
        "D": torch.zeros(shape, dtype=torch.float32, device=dev),
        "nc": torch.zeros(shape, dtype=torch.int32, device=dev),
        "done": ~pack_image(torch.ones((height, width), dtype=torch.bool,
                                       device=dev), grid_x, grid_y),
    }
    live_tiles = torch.ones(T_tiles, dtype=torch.bool, device=dev)

    def shift(win, popm):
        return {f: _shift_out(x, popm, inf if f == "d" else 0.0)
                for f, x in win.items()}

    def head_pop(pop_h):
        head = st["head"]
        a0, d0, g0 = head["a"][0], head["d"][0], head["g"][0]
        T = st["T"]
        U = T * (1.0 - a0)
        commit = pop_h & ~st["done"] & (U >= T_THRESHOLD)
        st["done"] = st["done"] | (pop_h & (U < T_THRESHOLD))
        w = a0 * T
        col = rgb[g0].permute(2, 0, 1)                            # [3, T, 256]
        st["C"] = torch.where(commit, st["C"] + w * col, st["C"])
        st["D"] = torch.where(commit, st["D"] + w * d0, st["D"])
        st["T"] = torch.where(commit, U, T)
        st["nc"] = st["nc"] + (commit & (a0 > 0.0)).to(torch.int32)
        st["head"] = shift(head, pop_h)
        st["fh"] = st["fh"] - pop_h.to(torch.int64)
        if count_evaluations:
            n["commits"] += int((commit & (a0 > 0.0)).sum())

    def push_head(pop_m):
        """Pop the mid front into the head where ``pop_m``."""
        mid = st["mid"]
        front = {"d": mid["dh"][0], "a": mid["a"][0], "g": mid["g"][0]}
        head_pop(pop_m & (st["fh"] == kh))
        st["head"] = _insert(st["head"], pop_m, front["d"], front)
        st["fh"] = st["fh"] + pop_m.to(torch.int64)
        st["mid"] = shift(mid, pop_m)
        st["fm"] = st["fm"] - pop_m.to(torch.int64)
        if count_evaluations:
            n["head_inserts"] += int((pop_m & live_tiles[:, None]).sum())

    def cascade(key_sub, gid_sub):
        """One emitted tail entry of every sub-tile ([T, 16]) into the mid
        and head windows of its 16 pixels."""
        v = torch.isfinite(key_sub)[:, sub_of_pix]                # [T, 256]
        gid = gid_sub[:, sub_of_pix]
        inv = cov3d_inv9[gid]
        d_mid = depth_along_ray(inv, vd_mid)
        d_head = depth_along_ray(inv, vd_head)
        co = conic_opacity[gid]
        dx = xy[gid, 0] - pix_x
        dy = xy[gid, 1] - pix_y
        a, b, c, o = co.unbind(-1)
        power = 0.5 * (a * dx * dx + c * dy * dy) + b * dx * dy
        alpha = torch.clamp(o * torch.exp(-power), max=ALPHA_MAX)
        ok = (power >= 0.0) & (alpha >= ALPHA_THRESHOLD) & (d_head >= 0.0)
        a_eff = torch.where(ok, alpha, 0.0)
        push_head(v & (st["fm"] == km))
        st["mid"] = _insert(st["mid"], v, d_mid,
                            {"d": d_mid, "dh": d_head, "a": a_eff, "g": gid})
        st["fm"] = st["fm"] + v.to(torch.int64)
        if count_evaluations:
            n["evaluations"] += int((v & live_tiles[:, None]).sum())

    hold_k = torch.full((T_tiles, SUBTILES, kt), -inf, dtype=torch.float32,
                        device=dev)
    hold_g = torch.zeros((T_tiles, SUBTILES, kt), dtype=torch.int64, device=dev)
    n_stream = -(-max_count // B)
    for b in range(n_stream + -(-kt // B)):
        # K5 stops a tile whose pixels are all done before each of its
        # stream batches and before its drain (only counted here: a done
        # pixel's outputs do not change). Batches past a tile's segment
        # emit only ghosts, so the check at b = n_stream is its drain's.
        if b <= n_stream:
            live_tiles = live_tiles & ~st["done"].all(dim=1)
        if b < n_stream:
            pos = b * B + torch.arange(B, device=dev)
            live = pos[None, :] < counts[:, None]                 # [T, 64]
            gid = point_list[torch.where(live, starts64[:, None] + pos, 0)]
            gid = gid.to(torch.int64)
            d_tail = depth_along_ray(cov3d_inv9[gid][:, None],
                                     vd_tail[:, :, None])          # [T, 16, 64]
            valid = live[:, None, :] & (d_tail >= 0.0)
            if hier_4x4_culling:
                power4, _ = max_contrib_power_rect(
                    conic_opacity[gid][:, None], xy[gid][:, None],
                    st_min[:, :, None], st_min[:, :, None] + 3.0,
                    patch_w=3, patch_h=3)
                valid = valid & (power4 <= opacity_power_threshold[gid][:, None])
            key = torch.where(valid, d_tail, -inf)
            gids = gid[:, None, :].expand(-1, SUBTILES, -1)
            if count_evaluations:
                n["tail_keys"] += SUBTILES * int((live & live_tiles[:, None]).sum())
                ran = live_tiles & (b * B < counts)
        else:
            key = torch.full((T_tiles, SUBTILES, B), inf, device=dev)
            gids = torch.zeros((T_tiles, SUBTILES, B), dtype=torch.int64,
                               device=dev)
            ran = live_tiles
        if count_evaluations:
            n["tail_slots"] += SUBTILES * (kt + B) * int(ran.sum())
        srt_k, order = torch.sort(torch.cat([hold_k, key], dim=-1), dim=-1,
                                  stable=True)
        srt_g = torch.gather(torch.cat([hold_g, gids], dim=-1), -1, order)
        hold_k, hold_g = srt_k[..., B:], srt_g[..., B:]
        emit_k, emit_g = srt_k[..., :B], srt_g[..., :B]
        # Steps where no sub-tile emits a real entry change nothing.
        for e in torch.isfinite(emit_k).any(dim=1).any(dim=0).nonzero().flatten().tolist():
            cascade(emit_k[..., e], emit_g[..., e])
    for _ in range(km):
        push_head(st["fm"] > 0)
    for _ in range(kh):
        head_pop(st["fh"] > 0)
    out = tuple(unpack_image(x, grid_x, grid_y, width, height).contiguous()
                for x in (st["C"], st["T"], st["nc"], st["D"]))
    if count_evaluations:
        # An entry enters all 16 pixels of its sub-tile or none of them.
        n["mid_inserts"] = n["evaluations"] // 4
        return out + (n,)
    return out
