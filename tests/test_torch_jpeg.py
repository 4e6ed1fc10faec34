"""The port's JPEG codec (host C++, utils/image.py) against PIL, which links
libjpeg-turbo: the decoder on PIL-written files (4:2:0, 4:2:2, 4:4:4,
grayscale, restart intervals, sizes off the MCU grid, quality 75 and 95, a
1296x968 ScanNet-sized frame), the refusals, the encoder against PIL's
`save(format="JPEG", quality=q)`, and the loaders' reduction of such a
frame to 640x480 against PIL's.

Tolerances: none. The decoder reproduces libjpeg's default decode (islow
IDCT, fancy upsampling, its fixed-point YCbCr tables), so its pixels equal
PIL's; the encoder reproduces libjpeg's compression (colour conversion,
h2v2 downsampling, islow forward DCT, the quality-scaled standard tables
and the standard Huffman tables), so its files equal PIL's byte for byte,
and so do their quantized coefficients.
"""
import io

import numpy as np
import pytest
import torch
from PIL import Image, ImageOps

from gennerf_tpu_torch.utils.image import (
    decode_jpeg, encode_jpeg, read_jpeg, resize_bilinear, write_jpeg,
)

import _torch_threads  # noqa: F401  (sizes torch's threads per xdist worker)

SIZES = [(48, 64), (37, 51), (17, 3), (1, 1), (9, 130)]


def _image(h, w, channels=3, seed=0):
    """Smooth colour fields with noise: every coefficient band is used."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([127 + 120 * np.sin(x / 17.0 + k) * np.cos(y / 23.0 - k)
                    for k in range(channels)], -1)
    img = np.clip(img + rng.normal(0, 12, img.shape), 0, 255).astype(np.uint8)
    return img[:, :, 0] if channels == 1 else img


def _pil_jpeg(img, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _pil_decode(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)))


@pytest.mark.parametrize("quality", [75, 95])
@pytest.mark.parametrize("subsampling", [0, 1, 2], ids=["444", "422", "420"])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_decode_matches_pil(size, subsampling, quality):
    data = _pil_jpeg(_image(*size, seed=size[1]), quality=quality, subsampling=subsampling)
    ours = decode_jpeg(data)
    assert ours.dtype == np.uint8 and ours.shape == size + (3,)
    np.testing.assert_array_equal(ours, _pil_decode(data))


@pytest.mark.parametrize("kw", [dict(quality=90), dict(quality=90, restart_marker_blocks=3),
                                dict(quality=90, restart_marker_rows=1),
                                dict(quality=95, subsampling=1, restart_marker_blocks=1)],
                         ids=["gray", "dri_blocks", "dri_rows", "dri_422"])
def test_decode_grayscale_and_restarts_match_pil(kw):
    gray = "restart_marker_blocks" not in kw and "restart_marker_rows" not in kw
    img = _image(45, 61, 1 if gray else 3, seed=7)
    data = _pil_jpeg(img, **kw)
    assert gray or b"\xff\xdd" in data  # the DRI marker
    ours = decode_jpeg(data)
    assert ours.shape == img.shape
    np.testing.assert_array_equal(ours, _pil_decode(data))


def test_scannet_frame_matches_pil(tmp_path):
    """A 1296x968 colour frame at quality 95, read from a file."""
    img = _image(968, 1296, seed=3)
    path = str(tmp_path / "0.jpg")
    Image.fromarray(img).save(path, quality=95)
    np.testing.assert_array_equal(read_jpeg(path), _pil_decode(open(path, "rb").read()))


def test_refusals():
    """Progressive files raise NotImplementedError naming the SOF marker;
    a file that is not a JPEG, or is cut inside its headers, ValueError."""
    data = _pil_jpeg(_image(32, 32), quality=90, progressive=True)
    with pytest.raises(NotImplementedError, match="progressive.*0xC2"):
        decode_jpeg(data)
    with pytest.raises(ValueError, match="not a JPEG"):
        decode_jpeg(b"\x89PNG\r\n\x1a\n" + bytes(32))
    good = _pil_jpeg(_image(32, 32), quality=90)
    with pytest.raises(ValueError, match="corrupt"):
        decode_jpeg(good[:100])
    with pytest.raises(NotImplementedError, match="channels"):
        encode_jpeg(np.zeros((4, 4, 4), np.uint8))


def _scan(data: bytes) -> bytes:
    """The entropy-coded data after the SOS header."""
    i = data.index(b"\xff\xda")
    return data[i + 2 + int.from_bytes(data[i + 2:i + 4], "big"):]


@pytest.mark.parametrize("channels", [3, 1], ids=["rgb", "gray"])
@pytest.mark.parametrize("quality", [75, 95])
@pytest.mark.parametrize("size", SIZES + [(968, 1296)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_encode_matches_pil(tmp_path, size, quality, channels):
    """The encoder's file is PIL's byte for byte (so the scan data and the
    quantized coefficients are too); PIL decodes it to the port's decode."""
    img = _image(*size, channels, seed=size[0])
    ours = encode_jpeg(img, quality)
    ref = _pil_jpeg(img, quality=quality)
    assert _scan(ours) == _scan(ref)
    assert ours == ref
    np.testing.assert_array_equal(_pil_decode(ours), decode_jpeg(ours))
    path = str(tmp_path / "x.jpg")
    write_jpeg(path, img, quality)
    assert open(path, "rb").read() == ours


def test_scannet_frame_reduction_matches_pil():
    """The loaders' reduction of a decoded 1296x968 frame: padded to
    1296x972 (2 black rows above and below), then PIL's antialiased
    BILINEAR to 640x480 (7 taps an axis), bit for bit."""
    data = _pil_jpeg(_image(968, 1296, seed=9), quality=95)
    padded = np.pad(decode_jpeg(data), ((2, 2), (0, 0), (0, 0)))
    ref = Image.open(io.BytesIO(data))
    ref = ImageOps.expand(ref, border=(0, 2)).resize((640, 480), Image.BILINEAR)
    np.testing.assert_array_equal(resize_bilinear(padded, (640, 480)), np.asarray(ref))
