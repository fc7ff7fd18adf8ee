"""HIERARCHICAL sort-mode tile blend: the CUDA kernels K5 (forward) and K6
(backward) and their plain PyTorch versions.

K5 replaces ``stopthepop_tpu/kernels/hier_blend.py::blend_hier_forward``
(the Pallas ``_fwd_kernel``, per-entry and batched cascade) and K6 its
``blend_hier_backward``. Both run one cascade (``csrc/hier_common.cuh``):
one block of 256 threads per 16x16 tile, batches of the tile's (tile,
depth)-sorted pairs staged in shared memory, each quad's mid keys computed
once; K6 replays K5 and routes its gradients by groups of lanes that commit
the same pair. The source notes (``csrc/hier_common.cuh``,
``csrc/hier_blend_fwd.cu``, ``csrc/hier_blend_bwd.cu``) say what bounds
them on an H100 and how their design keeps the cascade exact.

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

``batched_cascade=True`` takes the batched cadence (JAX
``render_hierarchical_naive`` with ``batched_cascade=True``; its stable
argsort, not the Pallas kernel's bitonic merge). The tail is the same; each
tail round's 64 emitted entries enter the mid window keyed by d_mid where
their tail key is finite, ghosts and drain pads keyed -inf with alpha 0, in
8 sub-batches of ``CASC_BATCH`` = 8. A mid round sorts the hold (``km``
entries, ascending, first all -inf "bubbles") and the sub-batch stably
(hold first, then the sub-batch in emission order), emits the first 8 and
keeps the last ``km``. The emitted entries, keyed by d_head where their mid
key is finite (else by that key), run the same round through the head
window (``kh``, first all -inf bubbles), and the head's 8 emitted entries
blend in order. After the tail's drain, ``ceil(km / 8)`` mid rounds of +inf
pads, then the head hold blends in order. Non-finite head depths add 0 to
depth_acc (the Pallas batched path's rule). K5 and K6 take this cadence in
libraries of their own (``library``), built from
``csrc/hier_blend_{fwd,bwd}_batched.cu``.

Each wrapper launches its kernel for CUDA tensors and runs its plain version
for CPU tensors, and nothing else: on a CUDA tensor it launches the kernel
or raises. The plain versions share one replay (``_replay``): it holds the
tail of all tiles as [T, 16, kt + 64] and sorts it with
``torch.sort(stable=True)``, holds the mid and head windows as
[km | kh, T, 256] (the batched cadence sorts [km + 8 | kh + 8, T, 256]
stably), and repeats K5's arithmetic operation by operation; the
forward blends at each head pop (in differentiable torch operations, so
autograd through it checks the plain backward), the backward forms and
routes the commit's gradient terms in K6's order of summation.

Inputs: the sorted Gaussian ids ``point_list`` [N] int32, ``starts``/``ends``
[T] int32, the per-Gaussian rows ``xy`` [P, 2], ``conic_opacity`` [P, 4],
``rgb`` [P, 3], ``cov3d_inv9`` [P, 9] (packed Sigma^-1 and
u = Sigma^-1 (mean - campos)), ``opacity_power_threshold`` [P]
(log(opacity / alpha threshold)), the camera ``inverse_vp`` [4, 4] and
``campos`` [3] (float32), and the queue sizes (kt, km, kh). Outputs:
color [3, H, W] (raw; the caller composites the background), final_T
[H, W], n_contrib [H, W] int32, depth_acc [H, W]. K6 returns d_pair
[N, 9] in sorted-slot order, columns ``GRAD_COLS``; with a ``sub_tile`` map
(a 32x16 binning tile) [S, N, 9], one plane a sub-tile, as K4.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..constants import (
    ALPHA_MAX,
    ALPHA_THRESHOLD,
    CASC_BATCH,
    T_THRESHOLD,
    TAIL_BATCH,
    TILE_PIXELS,
    TILE_X,
    TILE_Y,
)
from ..ops.stopthepop import depth_along_ray, max_contrib_power_rect
from ..ops.transforms import compute_view_ray
from . import build
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
from .kbuffer_blend import (
    _check_float_rows,
    _commit_terms,
    _cuda_prelude,
    _insert,
    _pair_sums,
    _route_grouped,
    _shift_out,
    _warp_rows,
    backward_buffers,
)

KERNEL = "hier_blend_fwd"
SOURCE = "stopthepop_tpu_torch/csrc/hier_blend_fwd.cu"
REPLACES = "stopthepop_tpu/kernels/hier_blend.py:923"
BWD_KERNEL = "hier_blend_bwd"
BWD_SOURCE = "stopthepop_tpu_torch/csrc/hier_blend_bwd.cu"
BWD_REPLACES = "stopthepop_tpu/kernels/hier_blend.py:1652"
# The suffix of the batched cascade's K5 and K6 libraries: the same kernels
# at the batched cadence, each built from its own source (which includes
# the per-entry one) so that nvcc compiles the two in parallel.
BATCHED = "_batched"
# K5 and K6 are instantiated for the reference's mid and head window sizes
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


def bind(lib, backward=False, batched=False):
    """K5's (or K6's) C entry point in a loaded library, typed: the
    per-entry cascade's, or with ``batched`` the batched cascade's (the
    same interface)."""
    name = "stp_hier_blend_bwd" if backward else "stp_hier_blend_fwd"
    fn = getattr(lib, name + ("_batched" if batched else ""))
    if backward:
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_float] * 2
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_int]
                       + [ctypes.c_void_p] * 3)
    else:
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_float] * 2
                       + [ctypes.c_int] * 10 + [ctypes.c_void_p] * 5)
    fn.restype = ctypes.c_int
    return fn


def library(kernel: str, batched: bool = False) -> str:
    """The library of K5 (``KERNEL``) or K6 (``BWD_KERNEL``), with the
    batched cascade where ``batched``: ``csrc/<library>.cu``."""
    return kernel + (BATCHED if batched else "")


def source(kernel: str, batched: bool = False) -> str:
    """The source of ``library(kernel, batched)``, from the repo's root."""
    return f"stopthepop_tpu_torch/csrc/{library(kernel, batched)}.cu"


@functools.lru_cache(maxsize=None)
def _bind(batched=False):
    return bind(build.load(library(KERNEL, batched)), batched=batched)


@functools.lru_cache(maxsize=None)
def _bind_bwd(batched=False):
    return bind(build.load(library(BWD_KERNEL, batched)), backward=True,
                batched=batched)


def occupancy(kernel: str, kt: int, mid_max: int, head_max: int,
              batched: bool = False) -> dict:
    """What instantiation (mid_max, head_max) of K5 (``KERNEL``) or K6
    (``BWD_KERNEL``), with the batched cascade where ``batched``, reaches
    at tail size ``kt`` on the current device: resident blocks per SM,
    registers and local (spill) bytes a thread, shared bytes a block."""
    name = library(kernel, batched)
    fn = getattr(build.load(name), f"stp_{name}_occupancy")
    out = (ctypes.c_int * 4)()
    err = fn(kt, mid_max, head_max, out)
    if err != 0:
        raise RuntimeError(f"{kernel} occupancy query failed: cudaError_t {err}")
    return {"blocks_per_sm": out[0], "registers": out[1],
            "spill_bytes": out[2], "smem_bytes": out[3]}


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
                       grid_y: int, width: int, height: int,
                       batched_cascade: bool = False):
    """HIERARCHICAL blend of every tile's sorted segment (kernel K5).

    Returns (color [3, H, W] raw, final_T [H, W], n_contrib [H, W] int32,
    depth_acc [H, W]). ``batched_cascade`` takes the batched cadence (the
    module notes). CUDA tensors go to kernel K5 (counted in
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
            batched_cascade=batched_cascade,
        )
    cam, sx, sy = _cuda_prelude(xy, conic_opacity, inverse_vp, campos, width,
                                height)
    fn = _bind(bool(batched_cascade))
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


def thread_pixel(device):
    """[256] in-tile pixel (row-major) of each thread of K5 and K6: half-warp
    s is sub-tile s, its lanes 4q..4q+3 are its quad q, and lane r of a quad
    is the quad's pixel (r & 1, r >> 1)."""
    t = torch.arange(TILE_PIXELS, device=device)
    s, q, r = t >> 4, (t >> 2) & 3, t & 3
    x = (s & 3) * 4 + (q & 1) * 2 + (r & 1)
    y = (s >> 2) * 4 + (q >> 1) * 2 + (r >> 1)
    return y * TILE_X + x


def _gids(point_list, starts, src):
    """Gaussian ids of stream positions ``src`` [..., T, 256] of each tile's
    segment (positions outside the list are clamped: they are never read)."""
    idx = starts.to(torch.int64)[:, None] + src
    return point_list[idx.clamp(0, point_list.shape[0] - 1)].to(torch.int64)


def _quads(mask):
    """[T, 256] pixel mask -> [T, 64]: any pixel of each 2x2 quad."""
    return mask.reshape(-1, 8, 2, 8, 2).any(dim=4).any(dim=2)


def _replay(point_list, starts, ends, xy, conic_opacity, cov3d_inv9,
            opacity_power_threshold, inverse_vp, campos, *, queue_sizes,
            hier_4x4_culling, batched_cascade, grid_x, grid_y, width, height,
            done, pop, skip_done, n):
    """K5's cascade over every tile (the module docstring), the windows
    carrying each entry's position ``src`` in its tile's segment (-1 for
    the batched cascade's bubbles, ghosts and pads). Each head pop calls
    ``pop(pop_h, a0, d0, src, done)`` ([T, 256] each; ``done`` the pixels'
    latch), which blends (K5) or replays the blend's gradient (K6) and
    returns the new latch; ``done`` is the latch to start from. ``n``,
    where given, takes the counts of ``blend_hier_forward_plain``; with
    ``skip_done`` a done pixel does no per-pixel work (K6), else every pixel
    of a live tile does (K5). The point list is not empty."""
    kt, km, kh = queue_sizes
    dev = xy.device
    T_tiles = grid_x * grid_y
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
        w["src"] = torch.zeros((k, *shape), dtype=torch.int64, device=dev)
        return w

    st = {
        "mid": window(km, ("dh", "a")),   # key d_mid, then d_head, a, src
        "head": window(kh, ("a",)),       # key d_head, then a, src
        "fm": torch.zeros(shape, dtype=torch.int64, device=dev),
        "fh": torch.zeros(shape, dtype=torch.int64, device=dev),
        "done": done,
    }
    live_tiles = torch.ones(T_tiles, dtype=torch.bool, device=dev)

    def work(mask):
        """The pixels of ``mask`` whose work the kernel does (counted)."""
        return mask & (~st["done"] if skip_done else live_tiles[:, None])

    def shift(win, popm):
        return {f: _shift_out(x, popm, inf if f == "d" else 0.0)
                for f, x in win.items()}

    def head_pop(pop_h):
        head = st["head"]
        st["done"] = pop(pop_h, head["a"][0], head["d"][0], head["src"][0],
                         st["done"])
        st["head"] = shift(head, pop_h)
        st["fh"] = st["fh"] - pop_h.to(torch.int64)

    def push_head(pop_m):
        """Pop the mid front into the head where ``pop_m``."""
        mid = st["mid"]
        front = {"d": mid["dh"][0], "a": mid["a"][0], "src": mid["src"][0]}
        if n is not None:
            n["head_inserts"] += int(work(pop_m).sum())
        head_pop(pop_m & (st["fh"] == kh))
        st["head"] = _insert(st["head"], pop_m, front["d"], front)
        st["fh"] = st["fh"] + pop_m.to(torch.int64)
        st["mid"] = shift(mid, pop_m)
        st["fm"] = st["fm"] - pop_m.to(torch.int64)

    def cascade(key_sub, src_sub):
        """One emitted tail entry of every sub-tile ([T, 16]) into the mid
        and head windows of its 16 pixels."""
        v = torch.isfinite(key_sub)[:, sub_of_pix]                # [T, 256]
        src = src_sub[:, sub_of_pix]
        d_mid = depth_along_ray(cov3d_inv9[_gids(point_list, starts, src)],
                                vd_mid)
        d_head, a_eff = evaluate(src)
        if n is not None:
            busy = work(v)
            n["evaluations"] += int(busy.sum())
            n["mid_inserts"] += int(_quads(busy).sum())
        push_head(v & (st["fm"] == km))
        st["mid"] = _insert(st["mid"], v, d_mid,
                            {"d": d_mid, "dh": d_head, "a": a_eff, "src": src})
        st["fm"] = st["fm"] + v.to(torch.int64)

    def evaluate(src):
        """The head depth and alpha ([..., T, 256]) of the entries at
        stream positions ``src`` for every pixel."""
        gid = _gids(point_list, starts, src)
        d_head = depth_along_ray(cov3d_inv9[gid], vd_head)
        co = conic_opacity[gid]
        dx = xy[gid, 0] - pix_x
        dy = xy[gid, 1] - pix_y
        a, b, c, o = co.unbind(-1)
        power = 0.5 * (a * dx * dx + c * dy * dy) + b * dx * dy
        alpha = torch.clamp(o * torch.exp(-power), max=ALPHA_MAX)
        ok = (power >= 0.0) & (alpha >= ALPHA_THRESHOLD) & (d_head >= 0.0)
        return d_head, torch.where(ok, alpha, 0.0)

    # The batched cascade's windows hold their entries ascending by key,
    # first all -inf bubbles (src -1).
    bst = None if not batched_cascade else {
        "mid": {"d": torch.full((km, *shape), -inf, device=dev),
                "src": torch.full((km, *shape), -1, dtype=torch.int64,
                                  device=dev)},
        "head": {"d": torch.full((kh, *shape), -inf, device=dev),
                 "a": torch.zeros((kh, *shape), device=dev),
                 "src": torch.full((kh, *shape), -1, dtype=torch.int64,
                                   device=dev)}}

    def win_round(name, batch):
        """Sort the window ``name`` and a sub-batch ([CASC_BATCH, T, 256]
        each) stably by key, hold first; keep the last entries, return the
        first CASC_BATCH."""
        win = bst[name]
        cat = {f: torch.cat([win[f], batch[f]], dim=0) for f in win}
        order = torch.sort(cat["d"], dim=0, stable=True).indices
        srt = {f: torch.gather(x, 0, order) for f, x in cat.items()}
        bst[name] = {f: x[CASC_BATCH:] for f, x in srt.items()}
        return {f: x[:CASC_BATCH] for f, x in srt.items()}

    def blend_rows(rows):
        """Head pops of rows [j, T, 256], j in order: entries of alpha 0
        (bubbles, ghosts, pads included) change nothing and are skipped."""
        for j in range(rows["a"].shape[0]):
            a0 = rows["a"][j]
            d0 = rows["d"][j]
            st["done"] = pop(a0 > 0.0, a0,
                             torch.where(torch.isfinite(d0), d0, 0.0),
                             rows["src"][j], st["done"])

    def mid_round(batch):
        """One mid round, its head round and the head's blends."""
        emit = win_round("mid", batch)
        real = emit["src"] >= 0
        d_head, a_eff = evaluate(emit["src"])
        if n is not None:
            busy = int(work(real).sum())
            n["evaluations"] += busy
            n["head_inserts"] += busy
        blend_rows(win_round("head", {
            "d": torch.where(torch.isfinite(emit["d"]), d_head, emit["d"]),
            "a": torch.where(real, a_eff, 0.0), "src": emit["src"]}))

    def batched_rounds(emit_k, emit_s):
        """The 64 entries a tail round emits ([T, 16, 64]) through the mid
        window in sub-batches of CASC_BATCH; ghosts and pads keyed -inf."""
        for e0 in range(0, B, CASC_BATCH):
            ks = emit_k[..., e0:e0 + CASC_BATCH][:, sub_of_pix].permute(2, 0, 1)
            srcs = emit_s[..., e0:e0 + CASC_BATCH][:, sub_of_pix].permute(2, 0, 1)
            fin = torch.isfinite(ks)                       # [8, T, 256]
            d_mid = depth_along_ray(
                cov3d_inv9[_gids(point_list, starts, srcs)], vd_mid)
            if n is not None:
                n["mid_inserts"] += sum(int(_quads(work(f)).sum())
                                        for f in fin)
            mid_round({"d": torch.where(fin, d_mid, -inf),
                       "src": torch.where(fin, srcs, -1)})

    hold_k = torch.full((T_tiles, SUBTILES, kt), -inf, dtype=torch.float32,
                        device=dev)
    hold_s = torch.zeros((T_tiles, SUBTILES, kt), dtype=torch.int64, device=dev)
    n_stream = -(-max_count // B)
    for b in range(n_stream + -(-kt // B)):
        # The kernels stop a tile whose pixels are all done before each of
        # its stream batches and before its drain (only counted here: a done
        # pixel's outputs do not change). Batches past a tile's segment emit
        # only ghosts, so the check at b = n_stream is its drain's.
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
            srcs = pos.expand(T_tiles, SUBTILES, B)
            if n is not None:
                n["tail_keys"] += SUBTILES * int(
                    (live & live_tiles[:, None]).sum())
            ran = live_tiles & (b * B < counts)
        else:
            key = torch.full((T_tiles, SUBTILES, B), inf, device=dev)
            srcs = torch.zeros((T_tiles, SUBTILES, B), dtype=torch.int64,
                               device=dev)
            ran = live_tiles
        if n is not None:
            n["tail_slots"] += SUBTILES * (kt + B) * int(ran.sum())
        srt_k, order = torch.sort(torch.cat([hold_k, key], dim=-1), dim=-1,
                                  stable=True)
        srt_s = torch.gather(torch.cat([hold_s, srcs], dim=-1), -1, order)
        hold_k, hold_s = srt_k[..., B:], srt_s[..., B:]
        emit_k, emit_s = srt_k[..., :B], srt_s[..., :B]
        if batched_cascade:
            batched_rounds(emit_k, emit_s)
            continue
        # Steps where no sub-tile emits a real entry change nothing.
        for e in torch.isfinite(emit_k).any(dim=1).any(dim=0).nonzero().flatten().tolist():
            cascade(emit_k[..., e], emit_s[..., e])
    if batched_cascade:
        # ceil(km / 8) mid rounds of +inf pads, then the head hold in place.
        for _ in range(-(-km // CASC_BATCH)):
            mid_round({"d": torch.full((CASC_BATCH, *shape), inf, device=dev),
                       "src": torch.full((CASC_BATCH, *shape), -1,
                                         dtype=torch.int64, device=dev)})
        blend_rows(bst["head"])
        return
    for _ in range(km):
        push_head(st["fm"] > 0)
    for _ in range(kh):
        head_pop(st["fh"] > 0)


def _counts():
    return {"tail_keys": 0, "tail_slots": 0, "evaluations": 0,
            "mid_inserts": 0, "head_inserts": 0, "commits": 0}


def blend_hier_forward_plain(point_list, starts, ends, xy, conic_opacity, rgb,
                             cov3d_inv9, opacity_power_threshold, inverse_vp,
                             campos, *, queue_sizes, hier_4x4_culling: bool,
                             grid_x: int, grid_y: int, width: int, height: int,
                             batched_cascade: bool = False,
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
    queue_sizes = check_hier_queues(*queue_sizes)
    dev = xy.device
    n = _counts()
    if point_list.numel() == 0:  # nothing enters any window
        img = torch.zeros((height, width), dtype=torch.float32, device=dev)
        out = (torch.zeros((3, height, width), dtype=torch.float32,
                           device=dev), img + 1.0,
               torch.zeros((height, width), dtype=torch.int32, device=dev), img)
        return out + (n,) if count_evaluations else out
    shape = (grid_x * grid_y, TILE_PIXELS)
    acc = {"T": torch.ones(shape, dtype=torch.float32, device=dev),
           "C": torch.zeros((3, *shape), dtype=torch.float32, device=dev),
           "D": torch.zeros(shape, dtype=torch.float32, device=dev),
           "nc": torch.zeros(shape, dtype=torch.int32, device=dev)}

    def pop(pop_h, a0, d0, src, done):
        """The blend: U = T (1 - a0) commits where not done and U >= 1e-4."""
        T = acc["T"]
        U = T * (1.0 - a0)
        commit = pop_h & ~done & (U >= T_THRESHOLD)
        w = a0 * T
        col = rgb[_gids(point_list, starts, src)].permute(2, 0, 1)  # [3, T, 256]
        acc["C"] = torch.where(commit, acc["C"] + w * col, acc["C"])
        acc["D"] = torch.where(commit, acc["D"] + w * d0, acc["D"])
        acc["T"] = torch.where(commit, U, T)
        acc["nc"] = acc["nc"] + (commit & (a0 > 0.0)).to(torch.int32)
        if count_evaluations:
            n["commits"] += int((commit & (a0 > 0.0)).sum())
        return done | (pop_h & (U < T_THRESHOLD))

    _replay(point_list, starts, ends, xy, conic_opacity, cov3d_inv9,
            opacity_power_threshold, inverse_vp, campos,
            queue_sizes=queue_sizes, hier_4x4_culling=hier_4x4_culling,
            batched_cascade=batched_cascade, grid_x=grid_x, grid_y=grid_y,
            width=width, height=height,
            done=~pack_image(torch.ones((height, width), dtype=torch.bool,
                                        device=dev), grid_x, grid_y),
            pop=pop, skip_done=False, n=n if count_evaluations else None)
    out = tuple(unpack_image(x, grid_x, grid_y, width, height).contiguous()
                for x in (acc["C"], acc["T"], acc["nc"], acc["D"]))
    return out + (n,) if count_evaluations else out


def blend_hier_backward(point_list, starts, ends, xy, conic_opacity, rgb,
                        cov3d_inv9, opacity_power_threshold, inverse_vp,
                        campos, color, final_t, n_contrib, grad_color,
                        grad_final_t, *, queue_sizes, hier_4x4_culling: bool,
                        grid_x: int, grid_y: int, width: int, height: int,
                        sub_tile=None, num_sub: int = 1,
                        batched_cascade: bool = False):
    """Per-pair gradients of K5's color and final_T (kernel K6).

    Takes K5's inputs, its saved outputs ``color`` (raw, before the
    background), ``final_t`` and ``n_contrib``, and the cotangents
    ``grad_color`` [3, H, W] and ``grad_final_t`` [H, W]. Returns d_pair
    [N, 9] float32 in sorted-slot order, columns ``GRAD_COLS``: the gradient
    with respect to each pair's x, y, conic a, b, c, opacity and r, g, b,
    summed over the pixels that committed it. No gradient flows to
    ``cov3d_inv9``, the camera or ``opacity_power_threshold``: they only
    choose the cascade's order and validity. ``sub_tile`` and ``num_sub``
    as in ``global_blend.blend_global_backward``; ``batched_cascade`` as
    K5 was called. CUDA tensors go to kernel K6 (counted in
    ``blend_hier_backward.launches``); CPU tensors to the plain version.
    """
    kt, km, kh = check_hier_queues(*queue_sizes)
    _check_hier_inputs(point_list, starts, ends, xy, conic_opacity, rgb,
                       cov3d_inv9, opacity_power_threshold, inverse_vp, campos,
                       grid_x, grid_y, width, height)
    dev = xy.device
    _check_backward_inputs(color, final_t, n_contrib, grad_color,
                           grad_final_t, width, height, dev)
    check_planes(sub_tile, num_sub, grid_x * grid_y, dev)
    if dev.type == "cpu":
        return blend_hier_backward_plain(
            point_list, starts, ends, xy, conic_opacity, rgb, cov3d_inv9,
            opacity_power_threshold, inverse_vp, campos, color, final_t,
            n_contrib, grad_color, grad_final_t, queue_sizes=(kt, km, kh),
            hier_4x4_culling=hier_4x4_culling, grid_x=grid_x, grid_y=grid_y,
            width=width, height=height, sub_tile=sub_tile, num_sub=num_sub,
            batched_cascade=batched_cascade,
        )
    cam, sx, sy = _cuda_prelude(xy, conic_opacity, inverse_vp, campos, width,
                                height)
    fn = _bind_bwd(bool(batched_cascade))
    n_pairs = point_list.shape[0]
    scratch, d_pair = backward_buffers(num_sub, n_pairs, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(
        point_list.data_ptr(), starts.data_ptr(), ends.data_ptr(),
        xy.data_ptr(), conic_opacity.data_ptr(), rgb.data_ptr(),
        cov3d_inv9.data_ptr(), opacity_power_threshold.data_ptr(),
        cam.data_ptr(), sx, sy, kt, km, kh, _instance(km, MID_SIZES),
        _instance(kh, HEAD_SIZES), int(bool(hier_4x4_culling)),
        color.data_ptr(), final_t.data_ptr(), n_contrib.data_ptr(),
        grad_color.data_ptr(), grad_final_t.data_ptr(), grid_x, grid_y,
        width, height, None if sub_tile is None else sub_tile.data_ptr(),
        n_pairs, scratch.data_ptr(), d_pair.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"{BWD_KERNEL} launch failed: cudaError_t {err}")
    blend_hier_backward.launches += 1
    return plane_rows(d_pair, sub_tile)


blend_hier_backward.launches = 0


def blend_hier_backward_plain(point_list, starts, ends, xy, conic_opacity,
                              rgb, cov3d_inv9, opacity_power_threshold,
                              inverse_vp, campos, color, final_t, n_contrib,
                              grad_color, grad_final_t, *, queue_sizes,
                              hier_4x4_culling: bool, grid_x: int, grid_y: int,
                              width: int, height: int, sub_tile=None,
                              num_sub: int = 1, batched_cascade: bool = False,
                              count_evaluations: bool = False):
    """Plain PyTorch version of kernel K6, same signature and outputs.

    The replay repeats K5's cascade (``_replay``); only commits of a0 > 0
    count (a commit of a0 = 0 changes neither T nor any sum), and a pixel
    stops once it has made its ``n_contrib`` of them. At every commit, the
    algebra of K4
    (``kbuffer_blend.blend_kbuffer_backward_plain``):
      w = a0 T;  acc = acc + w (c.g);
      galpha = a0 < 0.99 ? (c.g) T - (S_tot - acc + K_T) / (1 - a0) : 0,
    with c.g formed from the entry's rgb and the pixel's g, S_tot = color . g
    and K_T = g_T final_T, and the nine terms from dpower = -a0 galpha. The
    terms are summed as K6 sums them: per tile and warp of 32 threads (K5's
    thread map, ``thread_pixel``), step by step; within a step the lanes
    that commit the same pair are summed in ascending lane order and the
    sum goes into the pair's row (``_route_grouped``); then each pair's 8
    warp rows in warp order. With ``count_evaluations`` it also returns the
    replay's counts (those of ``blend_hier_forward_plain``, over the pixels
    that have not stopped).
    """
    queue_sizes = check_hier_queues(*queue_sizes)
    dev = xy.device
    n_pairs = point_list.shape[0]
    n = _counts()
    d_pair = torch.zeros((num_sub, n_pairs, len(GRAD_COLS)),
                         dtype=torch.float32, device=dev)
    if n_pairs == 0:  # nothing to replay
        d_pair = plane_rows(d_pair, sub_tile)
        return (d_pair, n) if count_evaluations else d_pair
    T_tiles = grid_x * grid_y
    counts = (ends - starts).to(torch.int64)
    pix_x, pix_y = _tile_pixel_coords(grid_x, grid_y, dev)
    g = pack_image(grad_color, grid_x, grid_y)               # [3, T, 256]
    c = pack_image(color, grid_x, grid_y)
    s_tot = c[0] * g[0] + c[1] * g[1] + c[2] * g[2]
    k_t = pack_image(grad_final_t, grid_x, grid_y) * pack_image(
        final_t, grid_x, grid_y)
    target = pack_image(n_contrib, grid_x, grid_y)  # 0 outside the image
    rows = _warp_rows(T_tiles, int(counts.max()), dev)
    lanes = thread_pixel(dev)
    shape = (T_tiles, TILE_PIXELS)
    st = {"T": torch.ones(shape, dtype=torch.float32, device=dev),
          "acc_g": torch.zeros(shape, dtype=torch.float32, device=dev),
          "nc": torch.zeros(shape, dtype=torch.int32, device=dev)}

    def pop(pop_h, a0, d0, src, done):
        """A head pop's commit and its gradient terms, routed. Commits of
        a0 = 0 change nothing (their terms are +-0) and are skipped."""
        T = st["T"]
        U = T * (1.0 - a0)
        commit = pop_h & ~done & (U >= T_THRESHOLD) & (a0 > 0.0)
        gid = _gids(point_list, starts, src)
        col = rgb[gid]                                        # [T, 256, 3]
        cg = col[..., 0] * g[0] + col[..., 1] * g[1] + col[..., 2] * g[2]
        w = a0 * T
        acc_g = torch.where(commit, st["acc_g"] + w * cg, st["acc_g"])
        galpha = torch.where(a0 < ALPHA_MAX,
                             cg * T - (s_tot - acc_g + k_t) / (1.0 - a0), 0.0)
        vals = _commit_terms(a0, galpha, w, g, conic_opacity[gid],
                             xy[gid, 0] - pix_x, xy[gid, 1] - pix_y)
        _route_grouped(rows, commit[:, lanes], src[:, lanes], vals[:, lanes])
        st["T"] = torch.where(commit, U, T)
        st["acc_g"] = acc_g
        st["nc"] = st["nc"] + commit.to(torch.int32)
        if count_evaluations:
            n["commits"] += int(commit.sum())
        return done | (pop_h & (U < T_THRESHOLD)) | (st["nc"] == target)

    _replay(point_list, starts, ends, xy, conic_opacity, cov3d_inv9,
            opacity_power_threshold, inverse_vp, campos,
            queue_sizes=queue_sizes, hier_4x4_culling=hier_4x4_culling,
            batched_cascade=batched_cascade, grid_x=grid_x, grid_y=grid_y,
            width=width, height=height, done=target == 0, pop=pop, skip_done=True,
            n=n if count_evaluations else None)
    _pair_sums(rows, starts, counts, d_pair, sub_tile)
    d_pair = plane_rows(d_pair, sub_tile)
    return (d_pair, n) if count_evaluations else d_pair
