"""GLOBAL sort-mode tile blend: the CUDA kernels K1 (forward) and K2
(backward) and their plain PyTorch versions.

K1 replaces ``stopthepop_tpu/kernels/global_blend.py::blend_global_forward``.
The kernel (``csrc/global_blend_fwd.cu``) has the reference renderCUDA's
shape: one block of 256 threads per 16x16 tile, batches of 256 Gaussians
staged in shared memory, a sequential early-exit blend per pixel. K2
(``csrc/global_blend_bwd.cu``) replaces ``blend_global_backward``: the same
shape, one front-to-back replay per tile that uses the saved forward output,
per-pair gradients summed over the tile's pixels in a fixed order into each
pair's own slot. In both, each warp covers a ``WARP_SHAPE`` block of pixels
and skips the staged pairs whose footprint cannot reach it
(``kernels/footprint.py``), which changes no output bit. Their source notes
say what bounds them on an H100.

Each wrapper launches its kernel for CUDA tensors and runs its plain version
for CPU tensors, and nothing else: on a CUDA tensor it launches the kernel or
raises. The plain versions loop over the position k in the tile segments,
with the 256 pixels of every tile held as one [T, 256] state, and repeat the
kernel's arithmetic operation by operation (the multiplicative
transmittance, and K2's summation tree, included).

Inputs: the (tile, depth)-sorted Gaussian ids ``point_list`` [N] int32, the
per-tile ranges ``starts``/``ends`` [T] int32 and the per-Gaussian rows
``xy`` [P, 2], ``conic_opacity`` [P, 4], ``rgb`` [P, 3], ``depth`` [P]
(float32). Outputs: color [3, H, W] (raw; the caller composites the
background), final_T [H, W], n_contrib [H, W] int32 (1-based position in the
tile's segment of the last pair blended), depth_acc [H, W]. K2 takes the same rows, the saved forward output and
its cotangents, and returns d_pair [N, 9] in sorted-slot order (see
``blend_global_backward``).

The blend tiles are the pieces of the binning tiles (``binning_pieces``):
each binning tile is cut, from its own origin, into pieces of at most 16x16
pixels, and both kernels take the piece table ``pieces`` [T, 4] int32, each
blend tile's (x0, y0, w, h) in image pixels; the lanes outside a piece take
no part. Where both sides of the binning tile are multiples of 16 the
pieces are the image's 16x16 grid, the table the wrappers build when given
none. A binning tile of several pieces gives them the same segment:
``starts``/``ends`` then repeat the parent's range, and K2 takes
``sub_tile`` [T] int32, each blend tile's plane of a d_pair [S, N, 9], so
that the tiles that share a segment write disjoint rows
(``blend_vjp.sum_planes`` adds the planes in order).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..constants import (
    ALPHA_MAX,
    ALPHA_THRESHOLD,
    T_THRESHOLD,
    TILE_PIXELS,
    TILE_X,
    TILE_Y,
)
from . import build
from .footprint import WarpCounter, thread_pixels

KERNEL = "global_blend_fwd"
SOURCE = "stopthepop_tpu_torch/csrc/global_blend_fwd.cu"
REPLACES = "stopthepop_tpu/kernels/global_blend.py:238"
BWD_KERNEL = "global_blend_bwd"
BWD_SOURCE = "stopthepop_tpu_torch/csrc/global_blend_bwd.cu"
BWD_REPLACES = "stopthepop_tpu/kernels/global_blend.py:485"
# Columns of K2's per-pair gradient rows.
GRAD_COLS = ("x", "y", "a", "b", "c", "opacity", "r", "g", "b_rgb")
# The pixels a warp of K1 and of K2 covers: kWarpW, kWarpH of
# csrc/global_blend_fwd.cu and csrc/global_blend_bwd.cu.
WARP_SHAPE = (8, 4)


def bind(lib):
    """K1's C entry point in a loaded library, typed."""
    fn = lib.stp_global_blend_fwd
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 5)
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bind():
    return bind(build.load(KERNEL))


def bind_bwd(lib):
    """K2's C entry point in a loaded library, typed."""
    fn = lib.stp_global_blend_bwd
    fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bind_bwd():
    return bind_bwd(build.load(BWD_KERNEL))


def _occupancy(kernel, lib):
    lib = build.load(kernel) if lib is None else lib
    out = (ctypes.c_int * 4)()
    err = getattr(lib, f"stp_{kernel}_occupancy")(out)
    if err != 0:
        raise RuntimeError(
            f"{kernel} occupancy query failed: cudaError_t {err}")
    return {"blocks_per_sm": out[0], "registers": out[1],
            "spill_bytes": out[2], "static_smem_bytes": out[3]}


def occupancy_fwd(lib=None) -> dict:
    """What K1 (the checkout's build, or ``lib``) reaches on the current
    device: resident blocks per SM, registers and local (spill) bytes a
    thread, static shared bytes a block."""
    return _occupancy(KERNEL, lib)


def occupancy_bwd(lib=None) -> dict:
    """The same for K2."""
    return _occupancy(BWD_KERNEL, lib)


def _check_inputs(point_list, starts, ends, xy, conic_opacity, rgb, depth,
                  grid_x, grid_y, width, height, pieces=None):
    if grid_x != (width + TILE_X - 1) // TILE_X or grid_y != (height + TILE_Y - 1) // TILE_Y:
        raise ValueError(
            f"grid ({grid_x}, {grid_y}) does not tile a {width}x{height} image"
        )
    num_tiles = grid_x * grid_y if pieces is None else pieces.shape[0]
    P = xy.shape[0]
    expect = {
        "point_list": (point_list, torch.int32, None),
        "starts": (starts, torch.int32, (num_tiles,)),
        "ends": (ends, torch.int32, (num_tiles,)),
        "xy": (xy, torch.float32, (P, 2)),
        "conic_opacity": (conic_opacity, torch.float32, (P, 4)),
        "rgb": (rgb, torch.float32, (P, 3)),
    }
    if depth is not None:
        expect["depth"] = (depth, torch.float32, (P,))
    if pieces is not None:
        expect["pieces"] = (pieces, torch.int32, (num_tiles, 4))
    dev = xy.device
    for name, (t, dtype, shape) in expect.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, xy on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if point_list.dim() != 1:
        raise ValueError("point_list must be 1-D")


def check_planes(sub_tile, num_sub: int, num_tiles: int, device):
    """Validate a backward's ``sub_tile`` [T] int32 and plane count."""
    if sub_tile is None:
        if num_sub != 1:
            raise ValueError(f"num_sub={num_sub} needs a sub_tile map")
        return
    if num_sub < 1:
        raise ValueError(f"num_sub must be at least 1, got {num_sub}")
    if sub_tile.device != device:
        raise ValueError(f"sub_tile is on {sub_tile.device}, xy on {device}")
    if sub_tile.dtype != torch.int32:
        raise TypeError(f"sub_tile must be torch.int32, got {sub_tile.dtype}")
    if tuple(sub_tile.shape) != (num_tiles,) or not sub_tile.is_contiguous():
        raise ValueError(f"sub_tile must be a contiguous ({num_tiles},) "
                         f"tensor, got {tuple(sub_tile.shape)}")


def plane_rows(d_planes, sub_tile):
    """The caller's view of a backward's [S, N, 9] planes: [N, 9] when no
    ``sub_tile`` map was given (one plane), else the planes."""
    return d_planes[0] if sub_tile is None else d_planes


def _check_backward_inputs(color, final_t, n_contrib, grad_color,
                           grad_final_t, width, height, device):
    expect = {
        "color": (color, torch.float32, (3, height, width)),
        "final_t": (final_t, torch.float32, (height, width)),
        "n_contrib": (n_contrib, torch.int32, (height, width)),
        "grad_color": (grad_color, torch.float32, (3, height, width)),
        "grad_final_t": (grad_final_t, torch.float32, (height, width)),
    }
    for name, (t, dtype, shape) in expect.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, xy on {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_aligned(xy, conic_opacity, pieces):
    if (xy.data_ptr() % 8 or conic_opacity.data_ptr() % 16
            or pieces.data_ptr() % 16):
        raise ValueError("xy must be 8-byte and conic_opacity and pieces "
                         "16-byte aligned")


@functools.lru_cache(maxsize=None)
def binning_pieces(width: int, height: int, tile_x: int, tile_y: int,
                   device):
    """The blend tiles of the ``tile_x`` x ``tile_y`` binning tiles of a
    ``width`` x ``height`` image: (parent [T] int64, plane [T] int32,
    pieces [T, 4] int32 (x0, y0, w, h)), ordered by (y0, x0); cached per
    image size, bin and device.

    Binning tile (bx, by) is cut into sx x sy = ceil(tile_x / 16) x
    ceil(tile_y / 16) pieces: piece (i, j) has its origin at
    (bx tile_x + 16 i, by tile_y + 16 j), is min(16, tile_x - 16 i) x
    min(16, tile_y - 16 j) pixels and writes plane i + sx j; only the
    pieces whose origin lies on the image are mapped. Where both sides are
    multiples of 16 the pieces are the image's 16x16 tiles, row-major.
    """
    sx, sy = -(-tile_x // TILE_X), -(-tile_y // TILE_Y)
    bin_gx, bin_gy = -(-width // tile_x), -(-height // tile_y)
    by, j, bx, i = (g.reshape(-1) for g in torch.meshgrid(
        *(torch.arange(n, device=device) for n in (bin_gy, sy, bin_gx, sx)),
        indexing="ij"))
    x0 = bx * tile_x + TILE_X * i
    y0 = by * tile_y + TILE_Y * j
    keep = (x0 < width) & (y0 < height)
    pieces = torch.stack([x0, y0, torch.clamp(tile_x - TILE_X * i, max=TILE_X),
                          torch.clamp(tile_y - TILE_Y * j, max=TILE_Y)],
                         dim=1)[keep]
    parent = (by * bin_gx + bx)[keep]
    plane = (i + sx * j)[keep]
    return parent, plane.to(torch.int32), pieces.to(torch.int32).contiguous()


def _grid_pieces(pieces, width: int, height: int, device):
    """``pieces``, or where None the image's 16x16 grid as a piece table."""
    if pieces is None:
        return binning_pieces(width, height, TILE_X, TILE_Y, device)[2]
    return pieces


def blend_global_forward(point_list, starts, ends, xy, conic_opacity, rgb,
                         depth, *, grid_x: int, grid_y: int, width: int,
                         height: int, pieces=None):
    """Blend every tile's sorted segment front to back.

    Returns (color [3, H, W], final_T [H, W], n_contrib [H, W] int32,
    depth_acc [H, W]). ``grid_x`` x ``grid_y`` is the image's 16x16 grid;
    the blend tiles are ``pieces`` [T, 4] int32 (module notes), the grid's
    tiles where None, and ``starts``/``ends`` are [T]. CUDA tensors go to
    kernel K1 (counted in ``blend_global_forward.launches``); CPU tensors
    to the plain version.
    """
    pieces = _grid_pieces(pieces, width, height, xy.device)
    _check_inputs(point_list, starts, ends, xy, conic_opacity, rgb, depth,
                  grid_x, grid_y, width, height, pieces)
    dev = xy.device
    if dev.type == "cpu":
        return blend_global_forward_plain(
            point_list, starts, ends, xy, conic_opacity, rgb, depth,
            grid_x=grid_x, grid_y=grid_y, width=width, height=height,
            pieces=pieces,
        )
    if dev.type != "cuda":
        raise ValueError(f"no blend kernel for device {dev}")
    _check_aligned(xy, conic_opacity, pieces)
    fn = _bind()
    color = torch.empty((3, height, width), dtype=torch.float32, device=dev)
    final_t = torch.empty((height, width), dtype=torch.float32, device=dev)
    n_contrib = torch.empty((height, width), dtype=torch.int32, device=dev)
    depth_acc = torch.empty((height, width), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(
        point_list.data_ptr(), starts.data_ptr(), ends.data_ptr(),
        xy.data_ptr(), conic_opacity.data_ptr(), rgb.data_ptr(),
        depth.data_ptr(), pieces.data_ptr(), pieces.shape[0], width, height,
        color.data_ptr(), final_t.data_ptr(), n_contrib.data_ptr(),
        depth_acc.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"{KERNEL} launch failed: cudaError_t {err}")
    blend_global_forward.launches += 1
    return color, final_t, n_contrib, depth_acc


blend_global_forward.launches = 0


def _tile_pixel_coords(grid_x: int, grid_y: int, device):
    """(pix_x, pix_y) [T, 256] float32 in the kernel's in-tile row-major order."""
    tiles = torch.arange(grid_x * grid_y, device=device)
    j = torch.arange(TILE_PIXELS, device=device)
    pix_x = (tiles[:, None] % grid_x) * TILE_X + j[None, :] % TILE_X
    pix_y = (tiles[:, None] // grid_x) * TILE_Y + j[None, :] // TILE_X
    return pix_x.to(torch.float32), pix_y.to(torch.float32)


class BlendPixels(NamedTuple):
    """Each blend tile's 256 pixels in the kernels' in-tile row-major order:
    coordinates ``x``, ``y`` [T, 256] float32, ``inside`` [T, 256] (on the
    piece and on the image) and ``flat`` [T, 256] int64, the index into an
    image's H * W pixels (0 where not inside)."""
    x: torch.Tensor
    y: torch.Tensor
    inside: torch.Tensor
    flat: torch.Tensor

    def pack(self, img):
        """[..., H, W] image -> [..., T, 256], zero where not inside."""
        v = img.reshape(*img.shape[:-2], -1)[..., self.flat]
        return torch.where(self.inside, v, torch.zeros((), dtype=v.dtype))

    def unpack(self, tiles, width: int, height: int):
        """[..., T, 256] -> [..., H, W] image of the inside pixels."""
        out = tiles.new_zeros((*tiles.shape[:-2], height * width))
        out[..., self.flat[self.inside]] = tiles[..., self.inside]
        return out.reshape(*tiles.shape[:-2], height, width)


def blend_pixels(width: int, height: int, pieces) -> BlendPixels:
    """The pixels of the blend tiles ``pieces`` [T, 4] int32 (x0, y0, w, h)
    of a ``width`` x ``height`` image."""
    j = torch.arange(TILE_PIXELS, device=pieces.device)
    jx, jy = j % TILE_X, j // TILE_X
    pc = pieces.to(torch.int64)
    x, y = pc[:, 0:1] + jx, pc[:, 1:2] + jy
    inside = ((jx < pc[:, 2:3]) & (jy < pc[:, 3:4]) & (x < width)
              & (y < height))
    flat = torch.where(inside, y * width + x, 0)
    return BlendPixels(x.to(torch.float32), y.to(torch.float32), inside, flat)


def _grid_pixels(width: int, height: int, device) -> BlendPixels:
    """The pixels of the image's 16x16 tiles."""
    return blend_pixels(width, height,
                        binning_pieces(width, height, TILE_X, TILE_Y,
                                       device)[2])


def pack_image(img, grid_x: int, grid_y: int):
    """[..., H, W] image -> [..., T, 256] pixels of its ``grid_x`` x
    ``grid_y`` 16x16 tiles, zero past the edge (the inverse of
    ``unpack_image``)."""
    h, w = img.shape[-2:]
    if (grid_x, grid_y) != (-(-w // TILE_X), -(-h // TILE_Y)):
        raise ValueError(f"grid ({grid_x}, {grid_y}) does not tile a "
                         f"{w}x{h} image")
    return _grid_pixels(w, h, img.device).pack(img)


def unpack_image(tiles, grid_x: int, grid_y: int, width: int, height: int):
    """[..., T, 256] per-tile pixel values of the ``grid_x`` x ``grid_y``
    16x16 tiles -> [..., H, W] image (cropped)."""
    if tiles.shape[-2] != grid_x * grid_y:
        raise ValueError(f"{tiles.shape[-2]} tiles, not {grid_x}x{grid_y}")
    return _grid_pixels(width, height, tiles.device).unpack(tiles, width,
                                                            height)


def blend_global_forward_plain(point_list, starts, ends, xy, conic_opacity,
                               rgb, depth, *, grid_x: int, grid_y: int,
                               width: int, height: int, pieces=None,
                               count_evaluations: bool = False,
                               warp_counts: dict | None = None,
                               footprint_cull: bool = False):
    """Plain PyTorch version of kernel K1, same signature and outputs.

    Pixels outside the image or the piece start done, as in K1. With
    ``count_evaluations`` it also returns (evaluations, blends): how many
    (pixel, pair) alphas the kernel evaluates on these inputs and how many
    of those it blends, over the pixels of the whole tile grid. A dict
    ``warp_counts`` is filled with K1's warp counts
    (``footprint.WarpCounter``). With ``footprint_cull`` a warp skips the
    pairs its footprint test culls, as K1 does; the outputs stay the same
    bits.
    """
    dev = xy.device
    pieces = _grid_pieces(pieces, width, height, dev)
    T_tiles = starts.shape[0]
    counts = (ends - starts).to(torch.int64)
    max_count = int(counts.max()) if T_tiles else 0
    px = blend_pixels(width, height, pieces)
    pix_x, pix_y = px.x, px.y
    T = torch.ones((T_tiles, TILE_PIXELS), dtype=torch.float32, device=dev)
    C = torch.zeros((4, T_tiles, TILE_PIXELS), dtype=torch.float32, device=dev)
    n_contrib = torch.zeros((T_tiles, TILE_PIXELS), dtype=torch.int32, device=dev)
    done = ~px.inside
    feats = torch.cat([rgb, depth[:, None]], dim=1).T  # [4, P]
    evaluations = blends = 0
    if warp_counts is not None or footprint_cull:
        warps = WarpCounter(point_list, xy, conic_opacity,
                            pieces[:, :2].to(torch.float32), WARP_SHAPE)
    for k in range(max_count):
        live = k < counts  # [T]
        pos = torch.where(live, starts.to(torch.int64) + k, 0)
        g = point_list[pos].to(torch.int64)
        co = conic_opacity[g]
        dx = xy[g, 0][:, None] - pix_x
        dy = xy[g, 1][:, None] - pix_y
        a, b, c, o = (co[:, i : i + 1] for i in range(4))
        power = 0.5 * (a * dx * dx + c * dy * dy) + b * dx * dy
        alpha = torch.clamp(o * torch.exp(-power), max=ALPHA_MAX)
        test_t = T * (1.0 - alpha)
        active = live[:, None] & ~done
        if footprint_cull:
            active = active & warps.kept(pos)
        ok = active & (power >= 0.0) & (alpha >= ALPHA_THRESHOLD)
        stop = ok & (test_t < T_THRESHOLD)
        blend = ok & ~stop
        w = torch.where(blend, alpha * T, 0.0)
        C = C + feats[:, g][:, :, None] * w
        T = torch.where(blend, test_t, T)
        n_contrib = torch.where(blend, k + 1, n_contrib)
        done = done | stop
        if count_evaluations:
            evaluations += int(active.sum())
            blends += int(blend.sum())
        if warp_counts is not None:
            warps.step(pos, active, blend)
    if warp_counts is not None:
        warps.close()
        warp_counts.update(warps.counts)
    out = tuple(px.unpack(x, width, height)
                for x in (C[:3], T, n_contrib, C[3]))
    if count_evaluations:
        return out + (evaluations, blends)
    return out


def blend_global_backward(point_list, starts, ends, xy, conic_opacity, rgb,
                          color, final_t, n_contrib, grad_color, grad_final_t,
                          *, grid_x: int, grid_y: int, width: int,
                          height: int, sub_tile=None, num_sub: int = 1,
                          pieces=None):
    """Per-pair gradients of K1's color and final_T (kernel K2).

    Takes K1's inputs (without depth), its saved outputs ``color`` (raw,
    before the background), ``final_t`` and ``n_contrib``, and the
    cotangents ``grad_color`` [3, H, W] and ``grad_final_t`` [H, W]. Returns
    d_pair [N, 9] float32 in sorted-slot order, columns ``GRAD_COLS``: the
    gradient with respect to the pair's x, y, conic a, b, c, opacity and
    r, g, b, summed over the tile's pixels. Rows past a tile's last
    contributor are zero. With ``sub_tile`` [T] int32 (tiles that share a
    segment, see the module notes) it returns [num_sub, N, 9]: tile t's
    sums in plane ``sub_tile[t]``, zero where no tile of a plane reads a
    segment. ``pieces`` as in ``blend_global_forward``. CUDA tensors go to
    kernel K2 (counted in ``blend_global_backward.launches``); CPU tensors
    to the plain version.
    """
    pieces = _grid_pieces(pieces, width, height, xy.device)
    _check_inputs(point_list, starts, ends, xy, conic_opacity, rgb, None,
                  grid_x, grid_y, width, height, pieces)
    dev = xy.device
    _check_backward_inputs(color, final_t, n_contrib, grad_color,
                           grad_final_t, width, height, dev)
    check_planes(sub_tile, num_sub, starts.shape[0], dev)
    if dev.type == "cpu":
        return blend_global_backward_plain(
            point_list, starts, ends, xy, conic_opacity, rgb, color, final_t,
            n_contrib, grad_color, grad_final_t,
            grid_x=grid_x, grid_y=grid_y, width=width, height=height,
            sub_tile=sub_tile, num_sub=num_sub, pieces=pieces,
        )
    if dev.type != "cuda":
        raise ValueError(f"no blend kernel for device {dev}")
    _check_aligned(xy, conic_opacity, pieces)
    fn = _bind_bwd()
    n_pairs = point_list.shape[0]
    d_pair = torch.zeros((num_sub, n_pairs, len(GRAD_COLS)),
                         dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(
        point_list.data_ptr(), starts.data_ptr(), ends.data_ptr(),
        xy.data_ptr(), conic_opacity.data_ptr(), rgb.data_ptr(),
        color.data_ptr(), final_t.data_ptr(), n_contrib.data_ptr(),
        grad_color.data_ptr(), grad_final_t.data_ptr(),
        pieces.data_ptr(), pieces.shape[0], width, height,
        None if sub_tile is None else sub_tile.data_ptr(), n_pairs,
        d_pair.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"{BWD_KERNEL} launch failed: cudaError_t {err}")
    blend_global_backward.launches += 1
    return plane_rows(d_pair, sub_tile)


blend_global_backward.launches = 0


def _warp_tree_sum(v, shape=None):
    """Sum [..., 256] (pixels in the tile's row-major order) over the last
    axis in K2's order: a tree over each warp's 32 lanes that pairs lane l
    with l + 16, then l + 8, ..., l + 1 (warps of ``shape`` pixels, K2's
    ``WARP_SHAPE`` by default), then the 8 warp partials in order."""
    v = v[..., thread_pixels(WARP_SHAPE if shape is None else shape)]
    v = v.reshape(*v.shape[:-1], TILE_PIXELS // 32, 32)
    for off in (16, 8, 4, 2, 1):
        v = v[..., :off] + v[..., off:2 * off]
    partial = v[..., 0]
    total = partial[..., 0]
    for w in range(1, partial.shape[-1]):
        total = total + partial[..., w]
    return total


def blend_global_backward_plain(point_list, starts, ends, xy, conic_opacity,
                                rgb, color, final_t, n_contrib, grad_color,
                                grad_final_t, *, grid_x: int, grid_y: int,
                                width: int, height: int,
                                sub_tile=None, num_sub: int = 1,
                                pieces=None,
                                count_evaluations: bool = False,
                                warp_counts: dict | None = None,
                                footprint_cull: bool = False):
    """Plain PyTorch version of kernel K2, same signature and outputs.

    With ``count_evaluations`` it also returns (evaluations, blends): the
    (pixel, pair) alphas the replay evaluates and the blends among them.
    A dict ``warp_counts`` is filled with K2's warp counts
    (``footprint.WarpCounter``), ``warp_pass_steps`` being the (warp, pair)
    steps at which some lane blends: the steps that reduce the nine sums.
    With ``footprint_cull`` a warp skips the pairs its footprint test
    culls, as K2 does; the outputs stay the same bits.
    """
    dev = xy.device
    pieces = _grid_pieces(pieces, width, height, dev)
    T_tiles = starts.shape[0]
    n_pairs = point_list.shape[0]
    d_pair = torch.zeros((num_sub, n_pairs, len(GRAD_COLS)),
                         dtype=torch.float32, device=dev)
    plane = (torch.zeros(T_tiles, dtype=torch.int64, device=dev)
             if sub_tile is None else sub_tile.to(torch.int64))
    px = blend_pixels(width, height, pieces)
    g = px.pack(grad_color)                             # [3, T, 256]
    c = px.pack(color)
    s_tot = c[0] * g[0] + c[1] * g[1] + c[2] * g[2]
    kt = px.pack(grad_final_t) * px.pack(final_t)
    last = px.pack(n_contrib).amax(dim=1).to(torch.int64)
    counts = torch.minimum((ends - starts).to(torch.int64), last)
    max_count = int(counts.max()) if T_tiles else 0
    pix_x, pix_y = px.x, px.y
    T = torch.ones((T_tiles, TILE_PIXELS), dtype=torch.float32, device=dev)
    prefix = torch.zeros_like(T)
    done = ~px.inside
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    evaluations = blends = 0
    if warp_counts is not None or footprint_cull:
        warps = WarpCounter(point_list, xy, conic_opacity,
                            pieces[:, :2].to(torch.float32), WARP_SHAPE)
    for k in range(max_count):
        live = k < counts  # [T]
        pos = torch.where(live, starts.to(torch.int64) + k, 0)
        gid = point_list[pos].to(torch.int64)
        co = conic_opacity[gid]
        dx = xy[gid, 0][:, None] - pix_x
        dy = xy[gid, 1][:, None] - pix_y
        a, b, cc, o = (co[:, i : i + 1] for i in range(4))
        active = live[:, None] & ~done
        if footprint_cull:
            active = active & warps.kept(pos)
        power = 0.5 * (a * dx * dx + cc * dy * dy) + b * dx * dy
        alpha_raw = o * torch.exp(-power)
        alpha = torch.clamp(alpha_raw, max=ALPHA_MAX)
        test_t = T * (1.0 - alpha)
        ok = active & (power >= 0.0) & (alpha >= ALPHA_THRESHOLD)
        stop = ok & (test_t < T_THRESHOLD)
        blend = ok & ~stop
        col = rgb[gid]
        w = alpha * T
        cdotg = col[:, 0:1] * g[0] + col[:, 1:2] * g[1] + col[:, 2:3] * g[2]
        prefix = torch.where(blend, prefix + w * cdotg, prefix)
        galpha = cdotg * T - (s_tot - prefix + kt) / (1.0 - alpha)
        galpha = torch.where(alpha_raw < ALPHA_MAX, galpha, zero)
        dpower = -alpha * galpha
        vals = torch.stack([
            dpower * (a * dx + b * dy),
            dpower * (cc * dy + b * dx),
            dpower * 0.5 * dx * dx,
            dpower * dx * dy,
            dpower * 0.5 * dy * dy,
            galpha * alpha / torch.clamp(o, min=1e-12),
            w * g[0],
            w * g[1],
            w * g[2],
        ])  # [9, T, 256]
        sums = _warp_tree_sum(torch.where(blend, vals, zero))  # [9, T]
        d_pair[plane[live], pos[live]] = sums.T[live]
        T = torch.where(blend, test_t, T)
        done = done | stop
        if count_evaluations:
            evaluations += int(active.sum())
            blends += int(blend.sum())
        if warp_counts is not None:
            warps.step(pos, active, blend)
    if warp_counts is not None:
        warps.close()
        warp_counts.update(warps.counts)
    d_pair = plane_rows(d_pair, sub_tile)
    if count_evaluations:
        return d_pair, evaluations, blends
    return d_pair
