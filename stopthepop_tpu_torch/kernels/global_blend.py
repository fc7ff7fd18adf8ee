"""GLOBAL sort-mode tile blend, forward: the CUDA kernel K1 and its plain
PyTorch version.

Replaces ``stopthepop_tpu/kernels/global_blend.py::blend_global_forward``.
The kernel (``csrc/global_blend_fwd.cu``) has the reference renderCUDA's
shape: one block of 256 threads per 16x16 tile, batches of 256 Gaussians
staged in shared memory, a sequential early-exit blend per pixel. Its source
note says what bounds it on an H100.

``blend_global_forward`` launches the kernel for CUDA tensors and runs
``blend_global_forward_plain`` for CPU tensors, and nothing else: on a CUDA
tensor it launches the kernel or raises. The plain version loops over the
position k in the tile segments, with the 256 pixels of every tile held as
one [T, 256] state, and repeats the kernel's arithmetic operation by
operation (the multiplicative transmittance included).

Inputs: the (tile, depth)-sorted Gaussian ids ``point_list`` [N] int32, the
per-tile ranges ``starts``/``ends`` [T] int32 and the per-Gaussian rows
``xy`` [P, 2], ``conic_opacity`` [P, 4], ``rgb`` [P, 3], ``depth`` [P]
(float32). Outputs: color [3, H, W] (raw; the caller composites the
background), final_T [H, W], n_contrib [H, W] int32 (1-based position in the
tile's segment of the last pair blended), depth_acc [H, W].
"""

from __future__ import annotations

import ctypes
import functools

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

KERNEL = "global_blend_fwd"
SOURCE = "stopthepop_tpu_torch/csrc/global_blend_fwd.cu"
REPLACES = "stopthepop_tpu/kernels/global_blend.py:238"


@functools.lru_cache(maxsize=None)
def _bind():
    lib = build.load(KERNEL)
    fn = lib.stp_global_blend_fwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 5
    fn.restype = ctypes.c_int
    return fn


def _check_inputs(point_list, starts, ends, xy, conic_opacity, rgb, depth,
                  grid_x, grid_y, width, height):
    if grid_x != (width + TILE_X - 1) // TILE_X or grid_y != (height + TILE_Y - 1) // TILE_Y:
        raise ValueError(
            f"grid ({grid_x}, {grid_y}) does not tile a {width}x{height} image"
        )
    num_tiles = grid_x * grid_y
    P = xy.shape[0]
    expect = {
        "point_list": (point_list, torch.int32, None),
        "starts": (starts, torch.int32, (num_tiles,)),
        "ends": (ends, torch.int32, (num_tiles,)),
        "xy": (xy, torch.float32, (P, 2)),
        "conic_opacity": (conic_opacity, torch.float32, (P, 4)),
        "rgb": (rgb, torch.float32, (P, 3)),
        "depth": (depth, torch.float32, (P,)),
    }
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


def blend_global_forward(point_list, starts, ends, xy, conic_opacity, rgb,
                         depth, *, grid_x: int, grid_y: int, width: int,
                         height: int):
    """Blend every tile's sorted segment front to back.

    Returns (color [3, H, W], final_T [H, W], n_contrib [H, W] int32,
    depth_acc [H, W]). CUDA tensors go to kernel K1 (counted in
    ``blend_global_forward.launches``); CPU tensors to the plain version.
    """
    _check_inputs(point_list, starts, ends, xy, conic_opacity, rgb, depth,
                  grid_x, grid_y, width, height)
    dev = xy.device
    if dev.type == "cpu":
        return blend_global_forward_plain(
            point_list, starts, ends, xy, conic_opacity, rgb, depth,
            grid_x=grid_x, grid_y=grid_y, width=width, height=height,
        )
    if dev.type != "cuda":
        raise ValueError(f"no blend kernel for device {dev}")
    if xy.data_ptr() % 8 or conic_opacity.data_ptr() % 16:
        raise ValueError("xy must be 8-byte and conic_opacity 16-byte aligned")
    fn = _bind()
    color = torch.empty((3, height, width), dtype=torch.float32, device=dev)
    final_t = torch.empty((height, width), dtype=torch.float32, device=dev)
    n_contrib = torch.empty((height, width), dtype=torch.int32, device=dev)
    depth_acc = torch.empty((height, width), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(
        point_list.data_ptr(), starts.data_ptr(), ends.data_ptr(),
        xy.data_ptr(), conic_opacity.data_ptr(), rgb.data_ptr(),
        depth.data_ptr(), grid_x, grid_y, width, height,
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


def unpack_image(tiles, grid_x: int, grid_y: int, width: int, height: int):
    """[..., T, 256] per-tile pixel values -> [..., H, W] image (cropped)."""
    lead = tiles.shape[:-2]
    t = tiles.reshape(*lead, grid_y, grid_x, TILE_Y, TILE_X)
    t = t.movedim(-3, -2).reshape(*lead, grid_y * TILE_Y, grid_x * TILE_X)
    return t[..., :height, :width]


def blend_global_forward_plain(point_list, starts, ends, xy, conic_opacity,
                               rgb, depth, *, grid_x: int, grid_y: int,
                               width: int, height: int,
                               count_evaluations: bool = False):
    """Plain PyTorch version of kernel K1, same signature and outputs.

    With ``count_evaluations`` it also returns (evaluations, blends): how
    many (pixel, pair) alphas the kernel evaluates on these inputs and how
    many of those it blends, over the pixels of the whole tile grid.
    """
    dev = xy.device
    T_tiles = grid_x * grid_y
    counts = (ends - starts).to(torch.int64)
    max_count = int(counts.max()) if T_tiles else 0
    pix_x, pix_y = _tile_pixel_coords(grid_x, grid_y, dev)
    T = torch.ones((T_tiles, TILE_PIXELS), dtype=torch.float32, device=dev)
    C = torch.zeros((4, T_tiles, TILE_PIXELS), dtype=torch.float32, device=dev)
    n_contrib = torch.zeros((T_tiles, TILE_PIXELS), dtype=torch.int32, device=dev)
    done = torch.zeros((T_tiles, TILE_PIXELS), dtype=torch.bool, device=dev)
    feats = torch.cat([rgb, depth[:, None]], dim=1).T  # [4, P]
    evaluations = blends = 0
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
    color = unpack_image(C[:3], grid_x, grid_y, width, height)
    final_t = unpack_image(T, grid_x, grid_y, width, height)
    n_img = unpack_image(n_contrib, grid_x, grid_y, width, height)
    depth_acc = unpack_image(C[3], grid_x, grid_y, width, height)
    out = (color.contiguous(), final_t.contiguous(), n_img.contiguous(),
           depth_acc.contiguous())
    if count_evaluations:
        return out + (evaluations, blends)
    return out
