"""PER_PIXEL_KBUFFER sort-mode tile blend: the CUDA kernels K3 (forward) and
K4 (backward) and their plain PyTorch versions.

K3 replaces ``stopthepop_tpu/kernels/kbuffer_blend.py::blend_kbuffer_forward``
and K4 its ``blend_kbuffer_backward``; both have the shape of K1/K2 (one block
of 256 threads per 16x16 tile, batches of the tile's (tile, depth)-sorted
pairs staged in shared memory). Their source notes say what bounds them on an
H100 and how the backward sums its per-pair gradients without atomics.

Semantics (the reference's renderkBufferCUDA, resorted_render.cuh:17-221, and
JAX ``render/naive.py::render_kbuffer_naive``): every pixel keeps a window of
up to ``k`` entries (exact per-ray depth, alpha, rgb), sorted by depth. A pair
of the tile's stream is valid for a pixel where power >= 0, alpha >= 1/255
and its depth along the pixel's view ray >= 0. A valid pair that finds the
window full first pops the front (nearest) entry, then is inserted behind
every entry of equal or smaller depth. A pop commits (blends) where
U = T (1 - alpha) >= 1e-4 and sets the pixel's done latch where U < 1e-4;
after the stream, the window drains front to back. A done pixel never commits
again, so the kernels stop working on it.

Each wrapper launches its kernel for CUDA tensors and runs its plain version
for CPU tensors, and nothing else: on a CUDA tensor it launches the kernel or
raises. The plain versions loop over the position in the tile segments with
the 256 pixels of every tile held as one [T, 256] state and the window as
[k, T, 256], and repeat the kernels' arithmetic operation by operation (K4's
order of summation included). The plain forward is written in
differentiable torch operations, so autograd through it is an independent
check of the plain backward.

Inputs: the sorted Gaussian ids ``point_list`` [N] int32, ``starts``/``ends``
[T] int32, the per-Gaussian rows ``xy`` [P, 2], ``conic_opacity`` [P, 4],
``rgb`` [P, 3], ``cov3d_inv9`` [P, 9] (packed Sigma^-1 and
u = Sigma^-1 (mean - campos)), the camera ``inverse_vp`` [4, 4] and
``campos`` [3] (float32), and the window size ``k`` (1..24). Outputs of K3:
color [3, H, W] (raw; the caller composites the background), final_T [H, W],
n_contrib [H, W] int32 (the number of commits), depth_acc [H, W]
(sum of w * ray depth). K4 returns d_pair [N, 9] in sorted-slot order,
columns ``GRAD_COLS``; with a ``sub_tile`` map (a 32x16 binning tile, whose
two 16x16 halves share a segment) [S, N, 9], one plane a sub-tile, as K2
(``global_blend.py``), its scratch in planes too.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..constants import ALPHA_MAX, ALPHA_THRESHOLD, T_THRESHOLD, TILE_PIXELS
from ..ops.stopthepop import depth_along_ray
from ..ops.transforms import compute_view_ray
from . import build
from .footprint import WarpCounter, tile_origins
from .global_blend import (
    GRAD_COLS,
    _check_backward_inputs,
    _check_inputs,
    _tile_pixel_coords,
    check_planes,
    pack_image,
    plane_rows,
    unpack_image,
)

KERNEL = "kbuffer_blend_fwd"
SOURCE = "stopthepop_tpu_torch/csrc/kbuffer_blend_fwd.cu"
REPLACES = "stopthepop_tpu/kernels/kbuffer_blend.py:397"
BWD_KERNEL = "kbuffer_blend_bwd"
BWD_SOURCE = "stopthepop_tpu_torch/csrc/kbuffer_blend_bwd.cu"
BWD_REPLACES = "stopthepop_tpu/kernels/kbuffer_blend.py:1071"
# The window sizes the kernels are instantiated for (the reference's set,
# forward.cu:406-426); a run with window k uses the smallest one >= k.
WINDOW_SIZES = (1, 2, 4, 8, 12, 16, 20, 24)
# The pixels a warp of K3 covers: kWarpW, kWarpH of csrc/kbuffer_blend_fwd.cu.
WARP_SHAPE = (8, 4)
WARPS = TILE_PIXELS // 32
# K4's scratch row of a pair: its xy and conic (8 floats) and one row of
# gradient sums for each warp of its tile (8 x 9 floats), 320 bytes.
SCRATCH_FLOATS = 8 + WARPS * len(GRAD_COLS)


def check_window(k) -> int:
    """The k-buffer window size, an int in 1..24, or ValueError."""
    if isinstance(k, bool) or int(k) != k or not 1 <= k <= WINDOW_SIZES[-1]:
        raise ValueError(
            f"k-buffer window size must be an integer in 1..{WINDOW_SIZES[-1]} "
            f"(SortQueueSizes.per_pixel), got {k!r}")
    return int(k)


def _instance(k: int) -> int:
    return next(m for m in WINDOW_SIZES if m >= k)


def bind(lib, backward=False):
    """K3's (or K4's) C entry point in a loaded library, typed."""
    if backward:
        fn = lib.stp_kbuffer_blend_bwd
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_float] * 2
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_int]
                       + [ctypes.c_void_p] * 3)
    else:
        fn = lib.stp_kbuffer_blend_fwd
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_float] * 2
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 5)
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bind():
    return bind(build.load(KERNEL))


@functools.lru_cache(maxsize=None)
def _bind_bwd():
    return bind(build.load(BWD_KERNEL), backward=True)


def occupancy_bwd(max_k: int, lib=None) -> dict:
    """What instantiation ``max_k`` of K4 (the checkout's build, or ``lib``)
    reaches on the current device: resident blocks per SM, registers and
    local (spill) bytes a thread, static shared bytes a block (it takes no
    dynamic shared memory)."""
    return _occupancy(BWD_KERNEL, max_k, lib)


def occupancy_fwd(max_k: int, lib=None) -> dict:
    """The same for instantiation ``max_k`` of K3."""
    return _occupancy(KERNEL, max_k, lib)


def _occupancy(kernel, max_k, lib):
    lib = build.load(kernel) if lib is None else lib
    out = (ctypes.c_int * 4)()
    err = getattr(lib, f"stp_{kernel}_occupancy")(max_k, out)
    if err != 0:
        raise RuntimeError(
            f"{kernel} occupancy query failed: cudaError_t {err}")
    return {"blocks_per_sm": out[0], "registers": out[1],
            "spill_bytes": out[2], "static_smem_bytes": out[3],
            "dynamic_smem_bytes": 0}


def _check_float_rows(xy, expect):
    """``expect``: name -> (tensor, shape); each must be a contiguous float32
    tensor of that shape on ``xy``'s device."""
    for name, (t, shape) in expect.items():
        if t.device != xy.device:
            raise ValueError(f"{name} is on {t.device}, xy on {xy.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be torch.float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_kbuffer_inputs(point_list, starts, ends, xy, conic_opacity, rgb,
                          cov3d_inv9, inverse_vp, campos, k, grid_x, grid_y,
                          width, height):
    _check_inputs(point_list, starts, ends, xy, conic_opacity, rgb, None,
                  grid_x, grid_y, width, height)
    check_window(k)
    P = xy.shape[0]
    _check_float_rows(xy, {"cov3d_inv9": (cov3d_inv9, (P, 9)),
                           "inverse_vp": (inverse_vp, (4, 4)),
                           "campos": (campos, (3,))})


def _cuda_prelude(xy, conic_opacity, inverse_vp, campos, width, height):
    """Checks common to the launches of the kernels that take a camera;
    returns (cam [19], ndc scales)."""
    if xy.device.type != "cuda":
        raise ValueError(f"no kernel for device {xy.device}")
    if xy.data_ptr() % 8 or conic_opacity.data_ptr() % 16:
        raise ValueError("xy must be 8-byte and conic_opacity 16-byte aligned")
    cam = torch.cat([inverse_vp.reshape(-1), campos]).contiguous()
    return cam, 2.0 / width, 2.0 / height


def blend_kbuffer_forward(point_list, starts, ends, xy, conic_opacity, rgb,
                          cov3d_inv9, inverse_vp, campos, *, k: int,
                          grid_x: int, grid_y: int, width: int, height: int):
    """K-buffer blend of every tile's sorted segment (kernel K3).

    Returns (color [3, H, W], final_T [H, W], n_contrib [H, W] int32,
    depth_acc [H, W]). CUDA tensors go to kernel K3 (counted in
    ``blend_kbuffer_forward.launches``); CPU tensors to the plain version.
    """
    _check_kbuffer_inputs(point_list, starts, ends, xy, conic_opacity, rgb,
                          cov3d_inv9, inverse_vp, campos, k, grid_x, grid_y,
                          width, height)
    dev = xy.device
    if dev.type == "cpu":
        return blend_kbuffer_forward_plain(
            point_list, starts, ends, xy, conic_opacity, rgb, cov3d_inv9,
            inverse_vp, campos, k=k, grid_x=grid_x, grid_y=grid_y,
            width=width, height=height,
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
        cov3d_inv9.data_ptr(), cam.data_ptr(), sx, sy, k, _instance(k),
        grid_x, grid_y, width, height, color.data_ptr(), final_t.data_ptr(),
        n_contrib.data_ptr(), depth_acc.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"{KERNEL} launch failed: cudaError_t {err}")
    blend_kbuffer_forward.launches += 1
    return color, final_t, n_contrib, depth_acc


blend_kbuffer_forward.launches = 0


def _pair_alpha_depth(point_list, starts, counts, j, xy, conic_opacity,
                      cov3d_inv9, pix_x, pix_y, vd):
    """Pair j of every tile segment against the tile's 256 pixels: (live [T],
    gid [T], power, alpha, ray depth [T, 256]) in the kernels' order."""
    live = j < counts
    pos = torch.where(live, starts.to(torch.int64) + j, 0)
    gid = point_list[pos].to(torch.int64)
    co = conic_opacity[gid]
    dx = xy[gid, 0][:, None] - pix_x
    dy = xy[gid, 1][:, None] - pix_y
    a, b, c, o = (co[:, i:i + 1] for i in range(4))
    power = 0.5 * (a * dx * dx + c * dy * dy) + b * dx * dy
    alpha = torch.clamp(o * torch.exp(-power), max=ALPHA_MAX)
    depth = depth_along_ray(cov3d_inv9[gid][:, None, :], vd)
    return live, gid, power, alpha, depth


def _shift_out(x, popm, pad):
    """Drop the front window entry where ``popm`` ([k, T, 256] window)."""
    shifted = torch.cat([x[1:], torch.full_like(x[:1], pad)], dim=0)
    return torch.where(popm, shifted, x)


def _insert(win, ins, d_new, new):
    """Insert an entry behind every window entry of equal or smaller depth
    where ``ins``. ``win``: dict of [k, T, 256] with the depths under "d";
    ``new``: dict of [T, 256] values for the same keys."""
    k = win["d"].shape[0]
    pos = (win["d"] <= d_new).sum(dim=0)
    ik = torch.arange(k, device=pos.device)[:, None, None]
    out = {}
    for name, x in win.items():
        shifted = torch.cat([x[:1], x[:-1]], dim=0)
        put = torch.where(ik < pos, x, torch.where(ik == pos, new[name], shifted))
        out[name] = torch.where(ins, put, x)
    return out


def _view_rays(grid_x, grid_y, width, height, inverse_vp, campos, dev):
    pix_x, pix_y = _tile_pixel_coords(grid_x, grid_y, dev)
    vd = compute_view_ray(torch.stack([pix_x, pix_y], dim=-1), width, height,
                          inverse_vp, campos)
    return pix_x, pix_y, vd


def blend_kbuffer_forward_plain(point_list, starts, ends, xy, conic_opacity,
                                rgb, cov3d_inv9, inverse_vp, campos, *, k: int,
                                grid_x: int, grid_y: int, width: int,
                                height: int, count_evaluations: bool = False,
                                footprint_cull: bool = False):
    """Plain PyTorch version of kernel K3, same signature and outputs.

    With ``footprint_cull`` a warp skips the pairs its footprint test
    culls, as K3 does; the outputs stay the same bits.

    With ``count_evaluations`` it also returns a dict of what the kernel
    does on these inputs, over the pixels of the whole tile grid:
    ``evaluations`` (pair alphas evaluated), ``depths`` (ray depths
    evaluated: pairs that pass the alpha tests), ``inserts`` and
    ``commits``, and K3's warp counts (``footprint.WarpCounter``), with
    ``warp_pass_steps`` the (warp, pair) steps at which some lane passes
    the alpha tests and ``chunk_max_passes`` the rounds of K3's second
    phase.
    """
    k = check_window(k)
    dev = xy.device
    T_tiles = grid_x * grid_y
    counts = (ends - starts).to(torch.int64)
    max_count = int(counts.max()) if T_tiles else 0
    pix_x, pix_y, vd = _view_rays(grid_x, grid_y, width, height, inverse_vp,
                                  campos, dev)
    shape = (T_tiles, TILE_PIXELS)
    zeros = torch.zeros((k, *shape), dtype=torch.float32, device=dev)
    win = {"d": torch.full_like(zeros, float("inf")), "a": zeros, "r": zeros,
           "g": zeros, "b": zeros}
    fill = torch.zeros(shape, dtype=torch.int64, device=dev)
    T = torch.ones(shape, dtype=torch.float32, device=dev)
    C = torch.zeros((3, *shape), dtype=torch.float32, device=dev)
    D = torch.zeros(shape, dtype=torch.float32, device=dev)
    nc = torch.zeros(shape, dtype=torch.int32, device=dev)
    done = ~pack_image(torch.ones((height, width), dtype=torch.bool,
                                  device=dev), grid_x, grid_y)
    n = {"evaluations": 0, "depths": 0, "inserts": 0, "commits": 0}
    if count_evaluations or footprint_cull:
        warps = WarpCounter(point_list, xy, conic_opacity,
                            tile_origins(grid_x, grid_x * grid_y, dev),
                            WARP_SHAPE)

    def pop(win, fill, T, C, D, nc, done, popm):
        a0 = win["a"][0]
        U = T * (1.0 - a0)
        commit = popm & ~done & (U >= T_THRESHOLD)
        done = done | (popm & (U < T_THRESHOLD))
        w = a0 * T
        C = torch.where(commit, C + w * torch.stack(
            [win["r"][0], win["g"][0], win["b"][0]]), C)
        D = torch.where(commit, D + w * win["d"][0], D)
        T = torch.where(commit, U, T)
        nc = nc + commit.to(torch.int32)
        win = {name: _shift_out(x, popm, float("inf") if name == "d" else 0.0)
               for name, x in win.items()}
        if count_evaluations:
            n["commits"] += int(commit.sum())
        return win, fill - popm.to(torch.int64), T, C, D, nc, done

    for j in range(max_count):
        live, gid, power, alpha, depth = _pair_alpha_depth(
            point_list, starts, counts, j, xy, conic_opacity, cov3d_inv9,
            pix_x, pix_y, vd)
        pos = torch.where(live, starts.to(torch.int64) + j, 0)
        active = live[:, None] & ~done
        if footprint_cull:
            active = active & warps.kept(pos)
        ok = active & (power >= 0.0) & (alpha >= ALPHA_THRESHOLD)
        v = ok & (depth >= 0.0)
        win, fill, T, C, D, nc, done = pop(win, fill, T, C, D, nc, done,
                                          v & (fill == k))
        ins = v & ~done
        col = rgb[gid]
        win = _insert(win, ins, depth, {
            "d": depth, "a": alpha, "r": col[:, 0:1].expand(shape),
            "g": col[:, 1:2].expand(shape), "b": col[:, 2:3].expand(shape)})
        fill = fill + ins.to(torch.int64)
        if count_evaluations:
            n["evaluations"] += int(active.sum())
            n["depths"] += int(ok.sum())
            n["inserts"] += int(ins.sum())
            warps.step(pos, active, ok)
    for _ in range(k):
        win, fill, T, C, D, nc, done = pop(win, fill, T, C, D, nc, done,
                                          (fill > 0) & ~done)
    out = tuple(unpack_image(x, grid_x, grid_y, width, height).contiguous()
                for x in (C, T, nc, D))
    if count_evaluations:
        warps.close()
        return out + ({**n, **warps.counts},)
    return out


def _warp_rows(T_tiles, max_count, dev):
    """Per (tile, warp) gradient rows of every tile's segment, [T, 8, L, 9],
    as the backward kernels keep them in their scratch."""
    return torch.zeros((T_tiles, WARPS, max(max_count, 1), len(GRAD_COLS)),
                       dtype=torch.float32, device=dev)


def _commit_terms(a0, galpha, w, g, co, dx, dy):
    """The nine per-pair gradient terms of a commit ([..., 9], columns
    ``GRAD_COLS``) from its alpha gradient, in the kernels' order."""
    a, b, c, o = co.unbind(-1)
    dpower = -a0 * galpha
    return torch.stack([
        dpower * (a * dx + b * dy),
        dpower * (c * dy + b * dx),
        dpower * 0.5 * dx * dx,
        dpower * dx * dy,
        dpower * 0.5 * dy * dy,
        galpha * a0 / torch.clamp(o, min=1e-12),
        w * g[0],
        w * g[1],
        w * g[2],
    ], dim=-1)


def _route_grouped(acc, commit, src, vals):
    """One step of K4's and K6's grouped routing (``csrc/route_common.cuh``).
    The committing lanes of a warp (``commit``, ``src`` [T, 256] and ``vals``
    [T, 256, 9], pixels in thread order) that name the same pair form a
    group; its terms are added in ascending lane order, from its lowest
    lane's on, and the group's sum is then added into the pair's row of the
    warp's ``acc`` [T, 8, L, 9]."""
    T_tiles = acc.shape[0]
    commit = commit.reshape(T_tiles, WARPS, 32)
    src = torch.where(commit, src.reshape(T_tiles, WARPS, 32), -1)
    vals = vals.reshape(T_tiles, WARPS, 32, len(GRAD_COLS))
    lane = torch.arange(32, device=acc.device)
    same = (src[..., :, None] == src[..., None, :]) & commit[..., None, :]
    leader = same.to(torch.uint8).argmax(dim=-1)     # lowest lane of the group
    joins = commit & (leader != lane)
    t_idx = torch.arange(T_tiles, device=acc.device)[:, None]
    w_idx = torch.arange(WARPS, device=acc.device)[None, :]
    sums = vals.clone()
    for o in joins.any(dim=1).any(dim=0).nonzero().flatten().tolist():
        m = joins[:, :, o]
        ld = leader[:, :, o]
        cur = sums[t_idx, w_idx, ld]
        sums[t_idx, w_idx, ld] = torch.where(m[..., None],
                                             cur + vals[:, :, o], cur)
    t, w, o = (commit & (leader == lane)).nonzero(as_tuple=True)
    s = src[t, w, o]
    acc[t, w, s] = acc[t, w, s] + sums[t, w, o]


def _pair_sums(acc, starts, counts, d_pair, sub_tile=None):
    """Each pair's warp rows added in warp order into its sorted slot of
    the tile's plane of ``d_pair`` [S, N, 9] (plane 0 without
    ``sub_tile``)."""
    total = acc[:, 0]
    for w in range(1, WARPS):
        total = total + acc[:, w]                          # [T, L, 9]
    s = torch.arange(total.shape[1], device=acc.device)[None, :]
    mine = s < counts[:, None]
    slot = starts.to(torch.int64)[:, None] + s
    plane = (torch.zeros_like(slot) if sub_tile is None
             else sub_tile.to(torch.int64)[:, None].expand_as(slot))
    d_pair[plane[mine], slot[mine]] = total[mine]


def blend_kbuffer_backward(point_list, starts, ends, xy, conic_opacity, rgb,
                           cov3d_inv9, inverse_vp, campos, color, final_t,
                           n_contrib, grad_color, grad_final_t, *, k: int,
                           grid_x: int, grid_y: int, width: int, height: int,
                           sub_tile=None, num_sub: int = 1):
    """Per-pair gradients of K3's color and final_T (kernel K4).

    Takes K3's inputs, its saved outputs ``color`` (raw, before the
    background), ``final_t`` and ``n_contrib``, and the cotangents
    ``grad_color`` [3, H, W] and ``grad_final_t`` [H, W]. Returns d_pair
    [N, 9] float32 in sorted-slot order, columns ``GRAD_COLS``: the gradient
    with respect to each pair's x, y, conic a, b, c, opacity and r, g, b,
    summed over the pixels that committed it. No gradient flows to
    ``cov3d_inv9`` or the camera: the window order is a discrete choice.
    ``sub_tile`` and ``num_sub`` as in ``blend_global_backward``. CUDA
    tensors go to kernel K4 (counted in
    ``blend_kbuffer_backward.launches``); CPU tensors to the plain version.
    """
    _check_kbuffer_inputs(point_list, starts, ends, xy, conic_opacity, rgb,
                          cov3d_inv9, inverse_vp, campos, k, grid_x, grid_y,
                          width, height)
    dev = xy.device
    _check_backward_inputs(color, final_t, n_contrib, grad_color,
                           grad_final_t, width, height, dev)
    check_planes(sub_tile, num_sub, grid_x * grid_y, dev)
    if dev.type == "cpu":
        return blend_kbuffer_backward_plain(
            point_list, starts, ends, xy, conic_opacity, rgb, cov3d_inv9,
            inverse_vp, campos, color, final_t, n_contrib, grad_color,
            grad_final_t, k=k, grid_x=grid_x, grid_y=grid_y, width=width,
            height=height, sub_tile=sub_tile, num_sub=num_sub,
        )
    cam, sx, sy = _cuda_prelude(xy, conic_opacity, inverse_vp, campos, width,
                                height)
    fn = _bind_bwd()
    n_pairs = point_list.shape[0]
    scratch, d_pair = backward_buffers(num_sub, n_pairs, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(
        point_list.data_ptr(), starts.data_ptr(), ends.data_ptr(),
        xy.data_ptr(), conic_opacity.data_ptr(), rgb.data_ptr(),
        cov3d_inv9.data_ptr(), cam.data_ptr(), sx, sy, k, _instance(k),
        color.data_ptr(), final_t.data_ptr(), n_contrib.data_ptr(),
        grad_color.data_ptr(), grad_final_t.data_ptr(), grid_x, grid_y, width,
        height, None if sub_tile is None else sub_tile.data_ptr(), n_pairs,
        scratch.data_ptr(), d_pair.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"{BWD_KERNEL} launch failed: cudaError_t {err}")
    blend_kbuffer_backward.launches += 1
    return plane_rows(d_pair, sub_tile)


blend_kbuffer_backward.launches = 0


def backward_buffers(num_sub: int, n_pairs: int, dev):
    """K4's and K6's scratch [S, N, 80] and d_pair [S, N, 9]. Each tile's
    block zeroes and fills its own rows [start, end) of its plane, and
    writes every row of them in d_pair; with S > 1 d_pair starts at zero,
    for the rows of a plane that no tile reads (the missing half of a
    binning tile at the image's right edge)."""
    scratch = torch.empty((num_sub, n_pairs, SCRATCH_FLOATS),
                          dtype=torch.float32, device=dev)
    alloc = torch.empty if num_sub == 1 else torch.zeros
    d_pair = alloc((num_sub, n_pairs, len(GRAD_COLS)), dtype=torch.float32,
                   device=dev)
    return scratch, d_pair


def blend_kbuffer_backward_plain(point_list, starts, ends, xy, conic_opacity,
                                 rgb, cov3d_inv9, inverse_vp, campos, color,
                                 final_t, n_contrib, grad_color, grad_final_t,
                                 *, k: int, grid_x: int, grid_y: int,
                                 width: int, height: int, sub_tile=None,
                                 num_sub: int = 1,
                                 count_evaluations: bool = False):
    """Plain PyTorch version of kernel K4, same signature and outputs.

    The replay repeats K3's decisions; a pixel stops once it has made its
    ``n_contrib`` commits. At every commit (JAX ``kbuffer_blend.py:658-675``,
    the algebra of K2):
      w = a0 T;  acc = acc + w (c.g);
      galpha = a0 < 0.99 ? (c.g) T - (S_tot - acc + K_T) / (1 - a0) : 0,
    with S_tot = color . g and K_T = g_T final_T per pixel, and the nine
    per-pair terms follow from dpower = -a0 galpha. The terms are summed as
    K4 sums them: per tile and warp of 32 pixels, step by step; within a
    step the lanes that commit the same pair are summed in ascending lane
    order and the sum goes into the pair's row (``_route_grouped``); then
    each pair's 8 warp sums in warp order. With ``count_evaluations`` it also
    returns K3's counts for the replay (see ``blend_kbuffer_forward_plain``).
    """
    k = check_window(k)
    dev = xy.device
    T_tiles = grid_x * grid_y
    n_pairs = point_list.shape[0]
    n = {"evaluations": 0, "depths": 0, "inserts": 0, "commits": 0}
    d_pair = torch.zeros((num_sub, n_pairs, len(GRAD_COLS)),
                         dtype=torch.float32, device=dev)
    if n_pairs == 0:  # nothing to replay
        d_pair = plane_rows(d_pair, sub_tile)
        return (d_pair, n) if count_evaluations else d_pair
    counts = (ends - starts).to(torch.int64)
    max_count = int(counts.max()) if T_tiles else 0
    pix_x, pix_y, vd = _view_rays(grid_x, grid_y, width, height, inverse_vp,
                                  campos, dev)
    shape = (T_tiles, TILE_PIXELS)
    g = pack_image(grad_color, grid_x, grid_y)               # [3, T, 256]
    c = pack_image(color, grid_x, grid_y)
    s_tot = c[0] * g[0] + c[1] * g[1] + c[2] * g[2]
    kt = pack_image(grad_final_t, grid_x, grid_y) * pack_image(
        final_t, grid_x, grid_y)
    target = pack_image(n_contrib, grid_x, grid_y)  # 0 outside the image
    zeros = torch.zeros((k, *shape), dtype=torch.float32, device=dev)
    win = {"d": torch.full_like(zeros, float("inf")), "a": zeros, "cg": zeros,
           "src": torch.zeros((k, *shape), dtype=torch.int64, device=dev)}
    fill = torch.zeros(shape, dtype=torch.int64, device=dev)
    T = torch.ones(shape, dtype=torch.float32, device=dev)
    acc_g = torch.zeros(shape, dtype=torch.float32, device=dev)
    nc = torch.zeros(shape, dtype=torch.int32, device=dev)
    done = target == 0
    acc = _warp_rows(T_tiles, max_count, dev)

    def pop(win, fill, T, acc_g, nc, done, popm):
        a0, cg, src = win["a"][0], win["cg"][0], win["src"][0]
        U = T * (1.0 - a0)
        commit = popm & ~done & (U >= T_THRESHOLD)
        done = done | (popm & (U < T_THRESHOLD))
        w = a0 * T
        acc_g = torch.where(commit, acc_g + w * cg, acc_g)
        galpha = torch.where(a0 < ALPHA_MAX,
                             cg * T - (s_tot - acc_g + kt) / (1.0 - a0), 0.0)
        gid = point_list[(starts.to(torch.int64)[:, None] + src).clamp(
            max=max(n_pairs - 1, 0))].to(torch.int64)
        vals = _commit_terms(a0, galpha, w, g, conic_opacity[gid],
                             xy[gid, 0] - pix_x, xy[gid, 1] - pix_y)
        _route_grouped(acc, commit, src, vals)
        T = torch.where(commit, U, T)
        nc = nc + commit.to(torch.int32)
        done = done | (nc == target)
        win = {name: _shift_out(x, popm, float("inf") if name == "d" else 0)
               for name, x in win.items()}
        if count_evaluations:
            n["commits"] += int(commit.sum())
        return win, fill - popm.to(torch.int64), T, acc_g, nc, done

    for j in range(max_count):
        live, gid, power, alpha, depth = _pair_alpha_depth(
            point_list, starts, counts, j, xy, conic_opacity, cov3d_inv9,
            pix_x, pix_y, vd)
        active = live[:, None] & ~done
        ok = active & (power >= 0.0) & (alpha >= ALPHA_THRESHOLD)
        v = ok & (depth >= 0.0)
        win, fill, T, acc_g, nc, done = pop(win, fill, T, acc_g, nc, done,
                                           v & (fill == k))
        ins = v & ~done
        col = rgb[gid]
        cg = col[:, 0:1] * g[0] + col[:, 1:2] * g[1] + col[:, 2:3] * g[2]
        win = _insert(win, ins, depth, {
            "d": depth, "a": alpha, "cg": cg,
            "src": torch.full(shape, j, dtype=torch.int64, device=dev)})
        fill = fill + ins.to(torch.int64)
        if count_evaluations:
            n["evaluations"] += int(active.sum())
            n["depths"] += int(ok.sum())
            n["inserts"] += int(ins.sum())
    for _ in range(k):
        win, fill, T, acc_g, nc, done = pop(win, fill, T, acc_g, nc, done,
                                           (fill > 0) & ~done)
    _pair_sums(acc, starts, counts, d_pair, sub_tile)
    d_pair = plane_rows(d_pair, sub_tile)
    if count_evaluations:
        return d_pair, n
    return d_pair
