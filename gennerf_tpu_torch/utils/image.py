"""PNG writing with numpy and zlib only (the port's own copy of `write_png`
and `encode_png` from gennerf_tpu/utils/image.py, without the PIL path)."""
from __future__ import annotations

import struct
import zlib

import numpy as np


def encode_png(array: np.ndarray) -> bytes:
    """(H, W) or (H, W, {1, 3, 4}) uint8, or (H, W) uint16 -> PNG bytes
    (8-bit gray/RGB/RGBA or 16-bit gray, one zlib stream, no filter)."""
    arr = np.asarray(array)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    H, W, C = arr.shape
    color_type = {1: 0, 3: 2, 4: 6}[C]
    bit_depth = 16 if arr.dtype == np.uint16 else 8
    if bit_depth == 16:
        raw = arr.astype(">u2").tobytes()
        stride = W * C * 2
    else:
        raw = arr.astype(np.uint8).tobytes()
        stride = W * C
    lines = b"".join(b"\x00" + raw[y * stride: (y + 1) * stride] for y in range(H))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))

    ihdr = struct.pack(">IIBBBBB", W, H, bit_depth, color_type, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(lines))
            + chunk(b"IEND", b""))


def write_png(path: str, array: np.ndarray) -> None:
    """Write `array` (see encode_png) to `path` as a PNG."""
    with open(path, "wb") as f:
        f.write(encode_png(array))
