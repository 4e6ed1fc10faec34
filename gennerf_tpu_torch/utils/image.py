"""PNG and JPEG reading and writing and the two image resizes of the data
pipeline, without PIL (the port's own copy of `write_png` and `encode_png`
from gennerf_tpu/utils/image.py, without the PIL path, plus a PNG decoder
and PIL's `Image.resize` in the modes the loaders use). PNG is numpy and
zlib; JPEG goes through the host library's baseline codec (utils/native.py),
which decodes to PIL's pixels and encodes PIL's files; the bilinear
resize's taps are computed here and its passes run in the host library.
"""
from __future__ import annotations

import struct
import zlib
from functools import lru_cache
from typing import Tuple

import numpy as np

from .native import jpeg_decode, jpeg_encode, resample_axis

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # PNG color type -> samples per pixel


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
    return (_SIGNATURE + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(lines))
            + chunk(b"IEND", b""))


def write_png(path: str, array: np.ndarray) -> None:
    """Write `array` (see encode_png) to `path` as a PNG."""
    with open(path, "wb") as f:
        f.write(encode_png(array))


def _unfilter_average(line: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(bpp):
        line[i] = (line[i] + (prev[i] >> 1)) & 0xFF
    for i in range(bpp, len(line)):
        line[i] = (line[i] + ((line[i - bpp] + prev[i]) >> 1)) & 0xFF


def _unfilter_paeth(line: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(bpp):
        line[i] = (line[i] + prev[i]) & 0xFF
    for i in range(bpp, len(line)):
        a, b, c = line[i - bpp], prev[i], prev[i - bpp]
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        line[i] = (line[i] + (a if pa <= pb and pa <= pc else b if pb <= pc else c)) & 0xFF


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W) for gray, else (H, W, C) array: uint8 for 8-bit,
    uint16 for 16-bit images. Takes gray, gray+alpha, RGB and RGBA at 8
    or 16 bits, any of the five line filters and any number of IDAT
    chunks; palette and interlaced images raise NotImplementedError."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG")
    pos, idat, header = 8, [], None
    while pos < len(data):
        length, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    W, H, bit_depth, color_type, _, _, interlace = header
    if color_type not in _CHANNELS or bit_depth not in (8, 16) or interlace:
        raise NotImplementedError(
            f"PNG color type {color_type}, {bit_depth} bits, interlace {interlace}")
    C = _CHANNELS[color_type]
    bpp = C * bit_depth // 8
    stride = W * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != H * (stride + 1):
        raise ValueError("PNG image data has the wrong size")
    rows = np.frombuffer(raw, np.uint8).reshape(H, stride + 1)
    out = np.empty((H, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(H):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            out[y] = line
        elif kind == 1:  # Sub: running sum along each byte lane
            out[y] = np.cumsum(line.reshape(W, bpp), axis=0, dtype=np.uint64).reshape(-1) & 0xFF
        elif kind == 2:  # Up
            out[y] = line + prev
        elif kind in (3, 4):
            buf = bytearray(line.tobytes())
            (_unfilter_average if kind == 3 else _unfilter_paeth)(buf, prev.tobytes(), bpp)
            out[y] = np.frombuffer(buf, np.uint8)
        else:
            raise ValueError(f"PNG filter type {kind}")
        prev = out[y]
    if bit_depth == 16:
        img = out.view(">u2").astype(np.uint16).reshape(H, W, C)
    else:
        img = out.reshape(H, W, C)
    return img[:, :, 0] if C == 1 else img


def read_png(path: str) -> np.ndarray:
    """Decode the PNG file at `path` (see decode_png)."""
    with open(path, "rb") as f:
        return decode_png(f.read())


def decode_jpeg(data: bytes) -> np.ndarray:
    """Baseline JPEG bytes -> (H, W) uint8 (grayscale) or (H, W, 3) RGB, as
    PIL decodes them; progressive and other non-baseline files raise
    NotImplementedError."""
    return jpeg_decode(data)


def read_jpeg(path: str) -> np.ndarray:
    """Decode the JPEG file at `path` (see decode_jpeg)."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read())


def encode_jpeg(array: np.ndarray, quality: int = 95) -> bytes:
    """(H, W) or (H, W, 3) uint8 -> the JPEG PIL's `save(format="JPEG",
    quality=quality)` writes (4:2:0 for colour)."""
    return jpeg_encode(array, quality)


def write_jpeg(path: str, array: np.ndarray, quality: int = 95) -> None:
    """Write `array` (see encode_jpeg) to `path` as a JPEG."""
    with open(path, "wb") as f:
        f.write(encode_jpeg(array, quality))


@lru_cache(maxsize=64)
def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """PIL's nearest source index per output position: a double that
    starts at scale/2 and adds scale per step, truncated."""
    scale = in_size / out_size
    idx = np.empty(out_size, np.int64)
    pos = scale * 0.5
    for i in range(out_size):
        idx[i] = int(pos)
        pos += scale
    return idx


def resize_nearest(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """PIL's `Image.resize(size, Image.NEAREST)` of an (H, W[, C]) array;
    `size` is (width, height) as PIL takes it."""
    width, height = size
    H, W = img.shape[:2]
    if (W, H) == (width, height):
        return img.copy()
    return img[_nearest_index(H, height)[:, None], _nearest_index(W, width)[None, :]]


_PRECISION_BITS = 32 - 8 - 2


@lru_cache(maxsize=64)
def _bilinear_coeffs(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """PIL's bilinear taps of one axis: (out, k) source indices and their
    fixed-point weights (precompute_coeffs + normalize_coeffs_8bpc in
    Resample.c, in double as there), as int32."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ss = 1.0 / filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    index = np.zeros((out_size, ksize), np.int32)
    weight = np.zeros((out_size, ksize), np.int32)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = []
        for x in range(xmax):
            t = abs((x + xmin - center + 0.5) * ss)
            k.append(1.0 - t if t < 1.0 else 0.0)
        ww = 0.0
        for w in k:
            ww += w
        for x, w in enumerate(k):
            w = w / ww if ww != 0.0 else w
            weight[xx, x] = int(0.5 + w * (1 << _PRECISION_BITS))
            index[xx, x] = x + xmin
    return index, weight


def _resample_axis(img: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    """One pass of PIL's 8-bit bilinear resample along `axis` (0 rows, 1
    columns) of an (H, W, C) uint8 array, rounded and clipped to uint8, in
    the host library (PIL's int32 fixed point)."""
    index, weight = _bilinear_coeffs(img.shape[axis], out_size)
    return resample_axis(img, axis, index, weight, _PRECISION_BITS)


def resize_bilinear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """PIL's `Image.resize(size, Image.BILINEAR)` of an (H, W, C) uint8
    array: the horizontal pass, rounded to uint8, then the vertical pass,
    in PIL's fixed point. `size` is (width, height)."""
    width, height = size
    out = img
    if out.shape[1] != width:
        out = _resample_axis(out, 1, width)
    if out.shape[0] != height:
        out = _resample_axis(out, 0, height)
    return out.copy() if out is img else out
