"""PER_PIXEL_FULL sort-mode tile blend: the CUDA kernel K7 (forward only) and
its plain PyTorch version.

K7 replaces ``stopthepop_tpu/kernels/full_blend.py::blend_full_forward``
(the Pallas ``_fwd_kernel``: five [seg_full, 128] VMEM planes sorted by an
unstable bitonic network, segments cut at ``seg_full``). Its shape is K3's:
one block of 256 threads per 16x16 tile, batches of the tile's pairs staged
in shared memory. It has no segment cap and sorts stably: each pixel keeps
a sorted list of ``WINDOW`` entries in shared memory, in passes over the
segment above a (depth, position) floor. The source note
(``csrc/full_blend_fwd.cu``) says how it sorts without scratch in device
memory and what bounds it on an H100.

Semantics (JAX ``render/naive.py::render_full_sort_naive``, the reference's
renderSortedFullCUDA, resorted_render.cuh:474-675). Each pixel evaluates
every pair of its tile's segment: power and alpha as in K1, the exact depth
along the pixel's view ray. A pair is active where power >= 0, alpha >= 1/255
and its ray depth >= 0. The actives are sorted by ray depth, exact ties in
stream order, and blended front to back with the log-space running sum:
S += log1p(-alpha), U = exp(S); the entry commits where U >= 1e-4 (w = alpha
T, C += w rgb, depth_acc += w depth, T = U) and the pixel stops at the
first entry where U < 1e-4.

The wrapper launches K7 for CUDA tensors (counted in
``blend_full_forward.launches``) and runs the plain version for CPU tensors,
and nothing else: on a CUDA tensor it launches the kernel or raises.

Passes: K7 streams a tile's segment once a pass, and the pixels that need
more than ``WINDOW`` actives before they saturate make it stream the
segment again. A pixel that saturates at its k-th active needs
ceil(k / WINDOW) passes, one whose A actives run out A // WINDOW + 1; a
tile takes as many as its slowest pixel on the image. Each K7 block adds
its tile's passes to an int64 counter on the device (one atomicAdd by
thread 0); the plain version counts by the same rule (``passes`` in its
counts), and on the CPU the wrapper adds those. The wrapper counts the
tiles it launches on the host. ``pass_counts()`` reads both, summed over
the process's launches, and is the one place that waits for the device.

The plain version computes the same function another way: per chunk of
tiles it builds the [tiles, 256, count] tables of alpha, ray depth and the
active flag (key +inf where inactive), sorts the key per pixel with
``torch.sort(stable=True)``, then walks the sorted positions in order with
K7's arithmetic, operation by operation.

Inputs: the sorted Gaussian ids ``point_list`` [N] int32, ``starts``/``ends``
[T] int32, the per-Gaussian rows ``xy`` [P, 2], ``conic_opacity`` [P, 4],
``rgb`` [P, 3], ``cov3d_inv9`` [P, 9] (packed Sigma^-1 and
u = Sigma^-1 (mean - campos)), the camera ``inverse_vp`` [4, 4] and
``campos`` [3] (float32). Outputs: color [3, H, W] (raw; the caller
composites the background), final_T [H, W] (the last committed U, 1 where
nothing commits), n_contrib [H, W] int32 (the number of commits: the rank of
the last committed entry), depth_acc [H, W] (sum of w * ray depth).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..constants import ALPHA_MAX, ALPHA_THRESHOLD, T_THRESHOLD, TILE_PIXELS
from ..ops.stopthepop import depth_along_ray
from . import build
from .global_blend import _check_inputs, pack_image, unpack_image
from .kbuffer_blend import _check_float_rows, _cuda_prelude, _view_rays

KERNEL = "full_blend_fwd"
SOURCE = "stopthepop_tpu_torch/csrc/full_blend_fwd.cu"
REPLACES = "stopthepop_tpu/kernels/full_blend.py:317"
# K7 takes each pixel's actives in passes ("rounds") of a sorted list of
# this many entries in shared memory (the constant kList of its source).
WINDOW = 48
# The plain version's tables hold at most this many (pixel, pair) entries
# at a time (about 40 bytes each with the sort's).
_CHUNK_ENTRIES = 1 << 25


def bind(lib):
    """K7's C entry point in a loaded library, typed."""
    fn = lib.stp_full_blend_fwd
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_float] * 2
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 6)
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bind():
    return bind(build.load(KERNEL))


class _Passes:
    """K7's passes and tiles, summed over the process's launches (module
    notes): an int64 counter on each device the kernel ran on, the passes
    the plain version counted on the CPU, and the tiles launched."""

    def __init__(self):
        self.device = {}
        self.host = 0
        self.tiles = 0

    def counter(self, dev) -> torch.Tensor:
        c = self.device.get(dev)
        if c is None:
            # A normal tensor, though the first frame may run under
            # inference_mode: the kernel adds to it in any mode.
            with torch.inference_mode(False):
                c = self.device[dev] = torch.zeros(1, dtype=torch.int64,
                                                   device=dev)
        return c


_PASSES = _Passes()


def pass_counts() -> tuple:
    """(passes, tiles): K7's passes over its tiles' segments and the tiles
    it ran, summed over every launch in this process (the plain version's,
    by the same rule, for CPU tensors). Waits for the devices K7 ran on."""
    passes = _PASSES.host + sum(int(c.item()) for c in _PASSES.device.values())
    return passes, _PASSES.tiles


def occupancy(lib=None) -> dict:
    """What K7 (the checkout's build, or ``lib``) reaches on the current
    device: resident blocks per SM, registers and local (spill) bytes a
    thread, static and dynamic (the list's) shared bytes a block, and the
    list's entries a pixel."""
    lib = build.load(KERNEL) if lib is None else lib
    out = (ctypes.c_int * 6)()
    err = lib.stp_full_blend_fwd_occupancy(out)
    if err != 0:
        raise RuntimeError(f"{KERNEL} occupancy query failed: cudaError_t {err}")
    return {"blocks_per_sm": out[0], "registers": out[1],
            "spill_bytes": out[2], "static_smem_bytes": out[3],
            "dynamic_smem_bytes": out[4], "list": out[5]}


def _check_full_inputs(point_list, starts, ends, xy, conic_opacity, rgb,
                       cov3d_inv9, inverse_vp, campos, grid_x, grid_y, width,
                       height):
    _check_inputs(point_list, starts, ends, xy, conic_opacity, rgb, None,
                  grid_x, grid_y, width, height)
    P = xy.shape[0]
    _check_float_rows(xy, {"cov3d_inv9": (cov3d_inv9, (P, 9)),
                           "inverse_vp": (inverse_vp, (4, 4)),
                           "campos": (campos, (3,))})


def blend_full_forward(point_list, starts, ends, xy, conic_opacity, rgb,
                       cov3d_inv9, inverse_vp, campos, *, grid_x: int,
                       grid_y: int, width: int, height: int):
    """Exact per-pixel sort and blend of every tile's segment (kernel K7).

    Returns (color [3, H, W], final_T [H, W], n_contrib [H, W] int32,
    depth_acc [H, W]).
    """
    _check_full_inputs(point_list, starts, ends, xy, conic_opacity, rgb,
                       cov3d_inv9, inverse_vp, campos, grid_x, grid_y, width,
                       height)
    dev = xy.device
    if dev.type == "cpu":
        *out, n = blend_full_forward_plain(
            point_list, starts, ends, xy, conic_opacity, rgb, cov3d_inv9,
            inverse_vp, campos, grid_x=grid_x, grid_y=grid_y, width=width,
            height=height, count_evaluations=True)
        _PASSES.host += n["passes"]
        _PASSES.tiles += grid_x * grid_y
        return tuple(out)
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
        cov3d_inv9.data_ptr(), cam.data_ptr(), sx, sy, grid_x, grid_y,
        width, height, color.data_ptr(), final_t.data_ptr(),
        n_contrib.data_ptr(), depth_acc.data_ptr(),
        _PASSES.counter(dev).data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"{KERNEL} launch failed: cudaError_t {err}")
    blend_full_forward.launches += 1
    _PASSES.tiles += grid_x * grid_y
    return color, final_t, n_contrib, depth_acc


blend_full_forward.launches = 0


def _chunk_tables(point_list, starts, counts, xy, conic_opacity, cov3d_inv9,
                  pix_x, pix_y, vd, inside, length):
    """The [c, 256, length] tables of one chunk of c tiles, pairs in stream
    order: (gid [c, length], ok (alpha tests passed), alpha, ray depth,
    active), in K7's order of operations."""
    j = torch.arange(length, device=xy.device)
    live = j[None, :] < counts[:, None]
    pos = torch.where(live, starts.to(torch.int64)[:, None] + j[None, :], 0)
    gid = point_list[pos].to(torch.int64)
    co = conic_opacity[gid]
    dx = xy[gid, 0][:, None, :] - pix_x[:, :, None]
    dy = xy[gid, 1][:, None, :] - pix_y[:, :, None]
    a, b, c, o = (co[:, None, :, i] for i in range(4))
    power = 0.5 * (a * dx * dx + c * dy * dy) + b * dx * dy
    alpha = torch.clamp(o * torch.exp(-power), max=ALPHA_MAX)
    ok = (live[:, None, :] & inside[:, :, None] & (power >= 0.0)
          & (alpha >= ALPHA_THRESHOLD))
    depth = depth_along_ray(cov3d_inv9[gid][:, None, :, :], vd[:, :, None, :])
    return gid, ok, alpha, depth, ok & (depth >= 0.0)


def blend_full_forward_plain(point_list, starts, ends, xy, conic_opacity, rgb,
                             cov3d_inv9, inverse_vp, campos, *, grid_x: int,
                             grid_y: int, width: int, height: int,
                             count_evaluations: bool = False):
    """Plain PyTorch version of kernel K7, same signature and outputs.

    With ``count_evaluations`` it also returns a dict of the work these
    inputs need, over the pixels of the image: ``evaluations`` ((pixel,
    pair) alphas), ``depths`` (ray depths: pairs that pass the alpha tests),
    ``actives``, ``sort_compares`` (sum over pixels of log2(n!) for n
    actives, the fewest compares that sort them), ``blended`` (sorted
    entries the blend reads, commits and each pixel's stopping entry) and
    ``commits``; ``passes``, the passes of K7's list over its segment
    summed over the tiles (each as many as its slowest pixel, module
    notes), and ``rounds``, their mean and largest a tile.
    """
    _check_full_inputs(point_list, starts, ends, xy, conic_opacity, rgb,
                       cov3d_inv9, inverse_vp, campos, grid_x, grid_y, width,
                       height)
    dev = xy.device
    T_tiles = grid_x * grid_y
    counts = (ends - starts).to(torch.int64)
    max_count = int(counts.max()) if T_tiles else 0
    pix_x, pix_y, vd = _view_rays(grid_x, grid_y, width, height, inverse_vp,
                                  campos, dev)
    inside = pack_image(torch.ones((height, width), dtype=torch.bool,
                                   device=dev), grid_x, grid_y)
    shape = (T_tiles, TILE_PIXELS)
    T_out = torch.ones(shape, dtype=torch.float32, device=dev)
    C_out = torch.zeros((3, *shape), dtype=torch.float32, device=dev)
    D_out = torch.zeros(shape, dtype=torch.float32, device=dev)
    nc_out = torch.zeros(shape, dtype=torch.int32, device=dev)
    n = {"evaluations": 0, "depths": 0, "actives": 0, "sort_compares": 0.0,
         "blended": 0, "commits": 0}
    rounds = torch.ones(T_tiles, dtype=torch.int64, device=dev)
    step = max(1, _CHUNK_ENTRIES // (TILE_PIXELS * max(max_count, 1)))
    for t0 in range(0, T_tiles, step):
        t1 = min(T_tiles, t0 + step)
        length = int(counts[t0:t1].max())
        if length == 0:
            continue
        gid, ok, alpha, depth, active = _chunk_tables(
            point_list, starts[t0:t1], counts[t0:t1], xy, conic_opacity,
            cov3d_inv9, pix_x[t0:t1], pix_y[t0:t1], vd[t0:t1],
            inside[t0:t1], length)
        # + 0.0 ties -0.0 with 0.0, as K7's compares do.
        key = torch.where(active, depth + 0.0, float("inf"))
        order = torch.sort(key, dim=-1, stable=True).indices
        a_s = torch.gather(alpha, -1, order)
        d_s = torch.gather(depth, -1, order)
        act_s = torch.gather(active, -1, order)
        g_s = torch.gather(gid[:, None, :].expand_as(order), -1, order)
        sub = (t1 - t0, TILE_PIXELS)
        S = torch.zeros(sub, dtype=torch.float32, device=dev)
        T = torch.ones(sub, dtype=torch.float32, device=dev)
        C = torch.zeros((3, *sub), dtype=torch.float32, device=dev)
        D = torch.zeros(sub, dtype=torch.float32, device=dev)
        nc = torch.zeros(sub, dtype=torch.int32, device=dev)
        done = ~act_s[..., 0]
        stop = torch.full(sub, -1, dtype=torch.int64, device=dev)
        for i in range(length):
            if i % 16 == 0 and bool(done.all()):
                break
            a = a_s[..., i]
            live = act_s[..., i] & ~done
            S1 = S + torch.log1p(-a)
            U = torch.exp(S1)
            commit = live & (U >= T_THRESHOLD)
            w = a * T
            col = rgb[g_s[..., i]]  # [c, 256, 3]
            C = torch.where(commit, C + w * col.permute(2, 0, 1), C)
            D = torch.where(commit, D + w * d_s[..., i], D)
            T = torch.where(commit, U, T)
            S = torch.where(commit, S1, S)
            nc = nc + commit.to(torch.int32)
            if count_evaluations:
                stop = torch.where(live & ~commit, i, stop)
                n["blended"] += int(live.sum())
                n["commits"] += int(commit.sum())
            done = done | (live & ~commit)
            if i + 1 < length:
                done = done | ~act_s[..., i + 1]
        T_out[t0:t1], C_out[:, t0:t1], D_out[t0:t1], nc_out[t0:t1] = T, C, D, nc
        if count_evaluations:
            n_act = active.sum(dim=-1)
            n["depths"] += int(ok.sum())
            n["actives"] += int(n_act.sum())
            n["sort_compares"] += float(
                torch.lgamma(n_act.to(torch.float64) + 1.0).sum() / math.log(2.0))
            # With a list of K = WINDOW entries, a pixel that stops at sorted
            # entry e blends it in round e // K + 1; one whose n actives run
            # out finds fewer than K entries in round n // K + 1.
            per_pixel = torch.where(stop >= 0, stop // WINDOW,
                                    n_act // WINDOW) + 1
            per_pixel = torch.where(inside[t0:t1], per_pixel, 0)
            rounds[t0:t1] = per_pixel.max(dim=-1).values
    out = tuple(unpack_image(x, grid_x, grid_y, width, height).contiguous()
                for x in (C_out, T_out, nc_out, D_out))
    if count_evaluations:
        n["evaluations"] = int((counts * inside.sum(dim=-1)).sum())
        n["sort_compares"] = int(math.ceil(n["sort_compares"]))
        n["passes"] = int(rounds.sum())
        n["rounds"] = ({"mean": float(rounds.to(torch.float64).mean()),
                        "max": int(rounds.max())} if T_tiles else {})
        return out + (n,)
    return out
