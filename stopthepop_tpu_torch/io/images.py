"""Image reading and 8-bit PNG writing.

Port of ``stopthepop_tpu/io/images.py``. ``read_png``, ``write_png`` and
``read_png_batch`` go through the port's native codec,
``native/png_io.cpp`` (chunk parsing, zlib inflate and scanline unfilter
behind a C ABI, through ctypes), which ``kernels/build.py::build_host``
compiles with the host compiler into ``build/torch_native/`` at first use.
A failed build raises: there is no fallback to the Python codec, which is
about 100 times slower on rows written with adaptive filters. Batches of
frames decode in a thread pool, since ctypes releases the GIL for the
native call. Other formats (the JPEG frames of COLMAP / MipNeRF-360
captures) decode through Pillow when it is installed.

``_read_png_python`` and ``_write_png_python`` are the plain versions
(numpy + zlib) that the tests and ``chip_smoke.py`` hold the codec against.

Supported subset: 8-bit gray / gray+alpha / RGB / RGBA, non-interlaced —
every frame in the NeRF-synthetic and MipNeRF-360 benchmark datasets.
"""

from __future__ import annotations

import ctypes
import functools
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np

from ..kernels import build

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_ERR_FORMAT = -3  # png_io.cpp: unsupported bit depth / color type / interlace
_U8P = ctypes.POINTER(ctypes.c_uint8)
_INTP = ctypes.POINTER(ctypes.c_int)


@functools.lru_cache(maxsize=None)
def _native() -> ctypes.CDLL:
    """The PNG codec, built at first use."""
    lib = build.load_host("png_io")
    lib.png_read_info.argtypes = [ctypes.c_char_p, _INTP, _INTP, _INTP]
    lib.png_read.argtypes = [ctypes.c_char_p, _U8P]
    lib.png_write.argtypes = [ctypes.c_char_p, _U8P, ctypes.c_int,
                              ctypes.c_int, ctypes.c_int]
    for fn in (lib.png_read_info, lib.png_read, lib.png_write):
        fn.restype = ctypes.c_int
    return lib


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit non-interlaced gray/RGB/RGBA PNG into [H, W, C] uint8.

    Raises ValueError for a PNG outside that subset and IOError for a file
    that cannot be read or decoded."""
    lib = _native()
    p = os.fsencode(path)
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.png_read_info(p, ctypes.byref(w), ctypes.byref(h), ctypes.byref(c))
    if rc == 0:
        out = np.empty((h.value, w.value, c.value), np.uint8)
        rc = lib.png_read(p, out.ctypes.data_as(_U8P))
        if rc == 0:
            return out
    if rc == _ERR_FORMAT:
        raise ValueError(
            f"{path}: unsupported PNG (need 8-bit non-interlaced "
            "gray/RGB/RGBA)"
        )
    raise IOError(f"{path}: PNG decode failed (rc={rc})")


def read_image(path: str) -> np.ndarray:
    """Read any supported image into [H, W, C] uint8.

    PNG goes through the native codec (``read_png``); other formats decode
    via Pillow, and raise IOError without it.
    """
    if path.lower().endswith(".png"):
        return read_png(path)
    try:
        from PIL import Image
    except ImportError as e:
        raise IOError(f"{path}: non-PNG images need Pillow") from e
    with Image.open(path) as im:
        if im.mode not in ("L", "RGB", "RGBA"):
            im = im.convert("RGB")
        arr = np.asarray(im, np.uint8)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


def read_png_batch(paths: List[str], n_threads: int = 8) -> List[np.ndarray]:
    """Decode many images in parallel (the native decode releases the GIL)."""
    if len(paths) <= 1:
        return [read_image(p) for p in paths]
    with ThreadPoolExecutor(max_workers=n_threads) as ex:
        return list(ex.map(read_image, paths))


def to_float_rgb(img: np.ndarray, bg: Optional[np.ndarray] = None) -> np.ndarray:
    """uint8 [H,W,C] -> float32 [H,W,3] in [0,1], alpha composited on ``bg``.

    As the standard 3DGS loader does: NeRF-synthetic frames are RGBA and are
    composited onto the training background color.
    """
    x = img.astype(np.float32) / 255.0
    if x.ndim == 2:
        x = x[:, :, None]
    if x.shape[2] == 1:
        return np.repeat(x, 3, axis=2)
    if x.shape[2] == 2:  # gray + alpha
        rgb = np.repeat(x[:, :, :1], 3, axis=2)
        a = x[:, :, 1:2]
    elif x.shape[2] == 4:
        rgb, a = x[:, :, :3], x[:, :, 3:4]
    else:
        return x[:, :, :3]
    if bg is None:
        bg = np.zeros(3, np.float32)
    return rgb * a + np.asarray(bg, np.float32) * (1.0 - a)


def write_png(path: str, img: np.ndarray) -> None:
    """Write a [H, W, C] or [H, W] uint8 array (C in 1-4) as an 8-bit PNG,
    every row with filter type 0."""
    if img.ndim == 2:
        img = img[:, :, None]
    if img.dtype != np.uint8:
        raise ValueError("write_png expects uint8")
    if img.ndim != 3 or img.shape[2] not in (1, 2, 3, 4):
        raise ValueError(f"write_png expects [H, W] or [H, W, 1-4], got {img.shape}")
    img = np.ascontiguousarray(img)
    h, w, c = img.shape
    rc = _native().png_write(os.fsencode(path), img.ctypes.data_as(_U8P), w, h, c)
    if rc != 0:
        raise IOError(f"{path}: PNG encode failed (rc={rc})")


# ---------------------------------------------------------------------------
# Plain versions (numpy + zlib)
# ---------------------------------------------------------------------------

def _read_png_python(path: str) -> np.ndarray:
    """Plain version of ``read_png`` (numpy + zlib, a Python loop over the
    bytes of each Sub, Average and Paeth row)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, ihdr = 8, [], None
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        payload = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", payload)
        elif ctype == b"IDAT":
            idat.append(payload)
        elif ctype == b"IEND":
            break
    if ihdr is None:
        raise ValueError(f"{path}: missing IHDR")
    w, h, depth, color, _, _, interlace = ihdr
    if depth != 8 or interlace != 0 or color not in _CHANNELS:
        raise ValueError(
            f"{path}: unsupported PNG (need 8-bit non-interlaced "
            "gray/RGB/RGBA)"
        )
    c = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    stride = w * c
    raw = raw.reshape(h, stride + 1)
    filters, lines = raw[:, 0], raw[:, 1:].astype(np.int32)
    out = np.zeros((h, stride), np.int32)
    for y in range(h):
        ft, row = int(filters[y]), lines[y].copy()
        prev = out[y - 1] if y else np.zeros(stride, np.int32)
        if ft == 0:
            out[y] = row
        elif ft == 1:
            for x in range(c, stride):
                row[x] = (row[x] + row[x - c]) & 0xFF
            out[y] = row
        elif ft == 2:
            out[y] = (row + prev) & 0xFF
        elif ft == 3:
            for x in range(stride):
                a = row[x - c] if x >= c else 0
                row[x] = (row[x] + ((a + prev[x]) >> 1)) & 0xFF
            out[y] = row
        elif ft == 4:
            for x in range(stride):
                a = row[x - c] if x >= c else 0
                b = prev[x]
                d = prev[x - c] if x >= c else 0
                p = a + b - d
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - d)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else d)
                row[x] = (row[x] + pred) & 0xFF
            out[y] = row
        else:
            raise ValueError(f"{path}: bad filter {ft}")
    return out.astype(np.uint8).reshape(h, w, c)


def _write_png_python(path: str, img: np.ndarray) -> None:
    """Plain version of ``write_png`` for a contiguous [H, W, C] uint8 array."""
    h, w, c = img.shape
    color = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1
    ).tobytes()

    def chunk(ctype: bytes, payload: bytes) -> bytes:
        crc = zlib.crc32(ctype + payload) & 0xFFFFFFFF
        return struct.pack(">I", len(payload)) + ctype + payload + struct.pack(
            ">I", crc
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIG)
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))
