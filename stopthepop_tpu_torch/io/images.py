"""8-bit PNG writing (pure Python zlib).

Port of ``stopthepop_tpu/io/images.py::write_png`` on its pure-Python path;
the native codec and the readers are not ported.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"


def write_png(path: str, img: np.ndarray) -> None:
    """Write a [H, W, C] or [H, W] uint8 array as an 8-bit PNG."""
    if img.ndim == 2:
        img = img[:, :, None]
    if img.dtype != np.uint8:
        raise ValueError("write_png expects uint8")
    img = np.ascontiguousarray(img)
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
