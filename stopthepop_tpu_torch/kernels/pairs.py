"""The pair stream as hand-written CUDA kernels and CUB's radix sort.

``csrc/pairs.cu`` replaces no Pallas kernel: the JAX package expands the
pairs in jnp and sorts them with ``jax.lax.sort``, which XLA fuses and
sorts; the port's torch path (``render/duplicate.py::expand_pairs`` and
``sort_expanded``) runs ~60 launches that gather over every pair in int64.
Here, as in the reference (rasterizer_impl.cu:221-413), three steps:

1. ``duplicate_with_keys``: the run offsets by a scan of ``tiles_touched``
   (CUB), the pair count read to the host (the frame's one sync), then one
   thread a Gaussian writes its pairs' 64-bit keys ``tile << 32 |
   bits(depth)`` (-0.0 made +0.0, as ``ops/sort.py`` does), each pair's
   expansion slot as its value and the slot's Gaussian, Gaussian-major and
   row-major within the rect, as ``expand_pairs`` orders them;
2. ``sort_and_identify``: CUB's radix sort of (key, slot) over the key's
   bits in use, ``[0, end_bit(num_tiles))``, stable like
   ``torch.sort(stable=True)``, so the permutation is the torch path's;
3. in the same call, one pass over the sorted keys writes ``PairBuffer``'s
   sorted fields and the tile ranges, empty tiles included.

Every field equals the torch path's bit for bit (``chip_smoke.py``, phase
kernel_pairs). ``render/duplicate.py::build_pairs`` takes this path where
``takes_kernel`` says so: CUDA tensors, a sort key that is the Gaussian's
own depth (Z_DEPTH, DISTANCE) and no tile-based culling. The torch path
is the plain version: CPU tensors and every other order take it, and the
wrappers take CUDA tensors only.
"""

from __future__ import annotations

import ctypes
import functools
import types
from typing import NamedTuple

import torch

from ..config import GlobalSortOrder
from . import build

KERNEL = "pairs"
SOURCE = "stopthepop_tpu_torch/csrc/pairs.cu"
# No Pallas kernel: the JAX package's jnp expansion and jax.lax.sort.
REPLACES = ("stopthepop_tpu/render/duplicate.py:188 expand_pairs, "
            ":389 sort_expanded")
# The orders whose key is the Gaussian's own depth (prep.depth).
KERNEL_ORDERS = (GlobalSortOrder.Z_DEPTH, GlobalSortOrder.DISTANCE)


class KeyedPairs(NamedTuple):
    """The unsorted, Gaussian-major pair stream of step 1."""

    keys: torch.Tensor      # [N] int64: tile << 32 | bits(depth)
    values: torch.Tensor    # [N] int32 expansion slot (0 .. N - 1)
    slot_gid: torch.Tensor  # [N] int32 Gaussian of each slot
    offsets: torch.Tensor   # [P + 1] int64 run offsets, cat([0], cumsum)


def takes_kernel(device, sort_order, tile_based_culling) -> bool:
    """Whether ``build_pairs`` runs the kernels: tensors on a CUDA device,
    a sort key that is ``prep.depth`` (Z_DEPTH or DISTANCE; PTD_CENTER and
    PTD_MAX key each pair by a depth of its own) and no tile-based culling
    (which drops pairs by a per-pair test)."""
    return (torch.device(device).type == "cuda"
            and GlobalSortOrder(sort_order) in KERNEL_ORDERS
            and not tile_based_culling)


def end_bit(num_tiles: int) -> int:
    """One past the highest key bit in use: the 32 depth bits and the
    bits of the largest tile id, at least one (rasterizer_impl.cu:344)."""
    return 32 + max(1, (num_tiles - 1).bit_length())


C_TYPES = {"int": ctypes.c_int, "unsigned long long": ctypes.c_ulonglong}
# The C entry points and their parameters' types, in order (pointers are
# c_void_p).
ENTRIES = {
    "stp_pairs_offsets_temp_bytes": ("int", "ptr"),
    "stp_pairs_offsets": ("ptr", "ptr", "int", "ptr", "unsigned long long",
                          "ptr"),
    "stp_pairs_duplicate": ("ptr",) * 5 + ("int", "int") + ("ptr",) * 4,
    "stp_pairs_sort_temp_bytes": ("int", "int", "ptr"),
    "stp_pairs_sort": ("ptr",) * 4 + ("int", "int", "ptr",
                                      "unsigned long long", "ptr", "ptr"),
    "stp_pairs_identify": ("ptr",) * 4 + ("int", "int") + ("ptr",) * 7,
}


def bind(lib):
    """The C entry points of a loaded library, typed, by their names
    without the ``stp_pairs_`` prefix."""
    fns = {}
    for name, params in ENTRIES.items():
        fn = getattr(lib, name)
        fn.argtypes = [C_TYPES.get(p, ctypes.c_void_p) for p in params]
        fn.restype = ctypes.c_int
        fns[name[len("stp_pairs_"):]] = fn
    return types.SimpleNamespace(**fns)


@functools.lru_cache(maxsize=None)
def _bind():
    return bind(build.load(KERNEL))


def _call(fn, *args):
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{KERNEL}: {fn.__name__} failed: cudaError_t {err}")


def _temp(query, *args, device):
    """Scratch for a CUB call, of the size CUB asks for."""
    need = ctypes.c_ulonglong()
    _call(query, *args, ctypes.byref(need))
    return torch.empty(max(need.value, 1), dtype=torch.uint8, device=device)


def _checked(name, t, dtype, shape, dev):
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, tiles_touched on {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    return t.detach().contiguous()


def duplicate_with_keys(tiles_touched, rect_min, rect_max, depth, *,
                        grid_x: int) -> KeyedPairs:
    """Step 1 on the card (counted in ``duplicate_with_keys.launches``):
    int32 ``tiles_touched`` [P], ``rect_min`` and ``rect_max`` [P, 2] in
    tiles of a ``grid_x``-wide grid, float32 ``depth`` [P]. Reads the pair
    count back to the host once."""
    dev = tiles_touched.device
    if dev.type != "cuda":
        raise ValueError(f"no pairs kernel for device {dev}")
    P = tiles_touched.shape[0]
    touched = _checked("tiles_touched", tiles_touched, torch.int32, (P,), dev)
    rect_min = _checked("rect_min", rect_min, torch.int32, (P, 2), dev)
    rect_max = _checked("rect_max", rect_max, torch.int32, (P, 2), dev)
    depth = _checked("depth", depth, torch.float32, (P,), dev)
    fns = _bind()
    stream = torch.cuda.current_stream(dev).cuda_stream
    offsets = torch.empty(P + 1, dtype=torch.int64, device=dev)
    temp = _temp(fns.offsets_temp_bytes, P, device=dev)
    _call(fns.offsets, touched.data_ptr(), offsets.data_ptr(), P,
          temp.data_ptr(), temp.numel(), stream)
    n = int(offsets[P])  # the reference's one read to the host
    if n >= 2**31 - 1:
        raise ValueError(f"{n} pairs: int32 slots and ranges hold fewer")
    keys = torch.empty(n, dtype=torch.int64, device=dev)
    values = torch.empty(n, dtype=torch.int32, device=dev)
    slot_gid = torch.empty(n, dtype=torch.int32, device=dev)
    _call(fns.duplicate, touched.data_ptr(), rect_min.data_ptr(),
          rect_max.data_ptr(), depth.data_ptr(), offsets.data_ptr(), P,
          grid_x, keys.data_ptr(), values.data_ptr(), slot_gid.data_ptr(),
          stream)
    duplicate_with_keys.launches += 1
    return KeyedPairs(keys, values, slot_gid, offsets)


def sort_and_identify(keyed: KeyedPairs, depth, *, num_tiles: int):
    """Steps 2 and 3 on the card (counted in ``sort_and_identify.launches``):
    (tile_id, depth, gauss_id, starts, ends, orig_slot) of ``PairBuffer``,
    from ``keyed`` and the Gaussians' ``depth`` [P] (read where a key's low
    word is 0, so that -0.0 keeps its sign)."""
    keys, values, slot_gid, _ = keyed
    dev = keys.device
    if dev.type != "cuda":
        raise ValueError(f"no pairs kernel for device {dev}")
    n = keys.shape[0]
    P = keyed.offsets.shape[0] - 1
    depth = _checked("depth", depth, torch.float32, (P,), dev)
    fns = _bind()
    stream = torch.cuda.current_stream(dev).cuda_stream
    bits = end_bit(num_tiles)
    keys_alt, values_alt = torch.empty_like(keys), torch.empty_like(values)
    temp = _temp(fns.sort_temp_bytes, n, bits, device=dev)
    selector = ctypes.c_int()
    _call(fns.sort, keys.data_ptr(), keys_alt.data_ptr(), values.data_ptr(),
          values_alt.data_ptr(), n, bits, temp.data_ptr(), temp.numel(),
          ctypes.byref(selector), stream)
    if selector.value:
        keys, values = keys_alt, values_alt
    out = (torch.empty(n, dtype=torch.int32, device=dev),
           torch.empty(n, dtype=torch.float32, device=dev),
           torch.empty(n, dtype=torch.int32, device=dev),
           torch.empty(num_tiles, dtype=torch.int32, device=dev),
           torch.empty(num_tiles, dtype=torch.int32, device=dev),
           torch.empty(n, dtype=torch.int64, device=dev))
    tile_id, s_depth, gauss_id, starts, ends, orig_slot = out
    _call(fns.identify, keys.data_ptr(), values.data_ptr(),
          slot_gid.data_ptr(), depth.data_ptr(), n, num_tiles,
          tile_id.data_ptr(), s_depth.data_ptr(), gauss_id.data_ptr(),
          orig_slot.data_ptr(), starts.data_ptr(), ends.data_ptr(), stream)
    sort_and_identify.launches += 1
    return out


duplicate_with_keys.launches = 0
sort_and_identify.launches = 0

