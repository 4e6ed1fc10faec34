"""ScanNet .sens (v4) reader, exporter and writer (counterpart of
gennerf_tpu/data/prepare/sensor_data.py): struct for the container, zlib
for the depth stream, the port's JPEG codec for the colour stream and its
PNG writer for 16-bit depth (utils/image.py), so nothing here needs PIL.
"""
from __future__ import annotations

import os
import struct
import tarfile
import zlib
from typing import Tuple

import numpy as np

from ...utils.image import decode_jpeg, encode_jpeg, write_jpeg, write_png

COMPRESSION_TYPE_COLOR = {-1: "unknown", 0: "raw", 1: "png", 2: "jpeg"}
COMPRESSION_TYPE_DEPTH = {-1: "unknown", 0: "raw_ushort", 1: "zlib_ushort", 2: "occi_ushort"}


class RGBDFrame:
    """One frame of a .sens file: camera_to_world (4, 4) float32, the two
    timestamps and the compressed colour and depth bytes."""

    def load(self, f):
        self.camera_to_world = np.asarray(
            struct.unpack("f" * 16, f.read(16 * 4)), dtype=np.float32).reshape(4, 4)
        self.timestamp_color = struct.unpack("Q", f.read(8))[0]
        self.timestamp_depth = struct.unpack("Q", f.read(8))[0]
        color_size = struct.unpack("Q", f.read(8))[0]
        depth_size = struct.unpack("Q", f.read(8))[0]
        self.color_data = f.read(color_size)
        self.depth_data = f.read(depth_size)

    def decompress_depth(self, compression_type: str) -> bytes:
        if compression_type == "zlib_ushort":
            return zlib.decompress(self.depth_data)
        if compression_type == "raw_ushort":
            return self.depth_data
        raise ValueError(f"invalid depth compression {compression_type}")

    def decompress_color(self, compression_type: str) -> np.ndarray:
        if compression_type == "jpeg":
            return decode_jpeg(self.color_data)
        raise ValueError(f"invalid color compression {compression_type}")


def _resize_nearest(arr: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """(H, W[, C]) nearest resize to (h, w)."""
    h, w = size
    ys = (np.arange(h) * arr.shape[0] / h).astype(int)
    xs = (np.arange(w) * arr.shape[1] / w).astype(int)
    return arr[ys][:, xs]


class SensorData:
    """Parser of .sens v4 containers, with the reference's exporters."""

    VERSION = 4

    def __init__(self, filename: str, archive_result: bool = False):
        self.archive_result = archive_result
        self.load(filename)

    def load(self, filename: str):
        def matrix(f):
            return np.asarray(struct.unpack("f" * 16, f.read(64)), np.float32).reshape(4, 4)

        with open(filename, "rb") as f:
            version = struct.unpack("I", f.read(4))[0]
            if version != self.VERSION:
                raise ValueError(f"unsupported .sens version {version}")
            strlen = struct.unpack("Q", f.read(8))[0]
            self.sensor_name = f.read(strlen).decode("utf-8")
            self.intrinsic_color = matrix(f)
            self.extrinsic_color = matrix(f)
            self.intrinsic_depth = matrix(f)
            self.extrinsic_depth = matrix(f)
            self.color_compression_type = COMPRESSION_TYPE_COLOR[struct.unpack("i", f.read(4))[0]]
            self.depth_compression_type = COMPRESSION_TYPE_DEPTH[struct.unpack("i", f.read(4))[0]]
            self.color_width = struct.unpack("I", f.read(4))[0]
            self.color_height = struct.unpack("I", f.read(4))[0]
            self.depth_width = struct.unpack("I", f.read(4))[0]
            self.depth_height = struct.unpack("I", f.read(4))[0]
            self.depth_shift = struct.unpack("f", f.read(4))[0]
            num_frames = struct.unpack("Q", f.read(8))[0]
            self.frames = []
            for _ in range(num_frames):
                frame = RGBDFrame()
                frame.load(f)
                self.frames.append(frame)

    # -- exporters ------------------------------------------------------------
    def _export_loop(self, output_path, ext, render, frame_skip, skip_existing):
        """render(i, fname) for every frame_skip-th frame into output_path;
        with archive_result the files go into output_path/<dirname>.tar."""
        output_dir = os.path.abspath(output_path)
        if os.path.exists(output_dir) and skip_existing:
            return
        os.makedirs(output_dir, exist_ok=True)
        names = []
        for i in range(0, len(self.frames), frame_skip):
            fname = os.path.join(output_dir, f"{i}{ext}")
            render(i, fname)
            names.append(fname)
        if self.archive_result:
            archive = os.path.join(output_dir, os.path.basename(output_dir) + ".tar")
            with tarfile.open(archive, "w") as tar:
                for fname in names:
                    tar.add(fname, arcname=os.path.basename(fname))
                    os.remove(fname)

    def export_depth_images(self, output_path, image_size=None, frame_skip=1, skip_existing=True):
        def render(i, fname):
            raw = self.frames[i].decompress_depth(self.depth_compression_type)
            depth = np.frombuffer(raw, dtype=np.uint16).reshape(self.depth_height,
                                                                self.depth_width)
            if image_size is not None:
                depth = _resize_nearest(depth, image_size)
            write_png(fname, depth)

        self._export_loop(output_path, ".png", render, frame_skip, skip_existing)

    def export_color_images(self, output_path, image_size=None, frame_skip=1, skip_existing=True):
        def render(i, fname):
            color = self.frames[i].decompress_color(self.color_compression_type)
            if image_size is not None:
                color = _resize_nearest(color, image_size)
            write_jpeg(fname, color, quality=95)

        self._export_loop(output_path, ".jpg", render, frame_skip, skip_existing)

    def export_poses(self, output_path, frame_skip=1, skip_existing=True):
        def render(i, fname):
            np.savetxt(fname, self.frames[i].camera_to_world, fmt="%f")

        self._export_loop(output_path, ".txt", render, frame_skip, skip_existing)

    def export_intrinsics(self, output_path, skip_existing=True):
        output_dir = os.path.abspath(output_path)
        if os.path.exists(output_dir) and skip_existing:
            return
        os.makedirs(output_dir, exist_ok=True)
        for name in ("intrinsic_color", "extrinsic_color", "intrinsic_depth", "extrinsic_depth"):
            np.savetxt(os.path.join(output_dir, f"{name}.txt"), getattr(self, name), fmt="%f")

    # -- .sens writer (tests and synthetic scenes) ----------------------------
    @staticmethod
    def write(filename: str, intrinsic_color: np.ndarray, depths_mm, colors, poses,
              depth_shift: float = 1000.0, sensor_name: str = "synthetic",
              intrinsic_depth=None) -> None:
        """Write a v4 .sens container: zlib uint16 depth, JPEG colour at
        quality 95. `depths_mm` (T, H, W), `colors` (T, CH, CW, 3) uint8 and
        `poses` (T, 4, 4) may be any sequences with len and indexing (frames
        are read one at a time). The depth camera's (3, 3) intrinsics default
        to the colour camera's, as the reference writer has them."""
        K = np.asarray(intrinsic_color, np.float32)
        Kd = K if intrinsic_depth is None else np.asarray(intrinsic_depth, np.float32)
        eye = np.eye(4, dtype=np.float32)
        K4, Kd4 = eye.copy(), eye.copy()
        K4[:3, :3] = K[:3, :3]
        Kd4[:3, :3] = Kd[:3, :3]
        T = len(depths_mm)
        H, W = np.shape(depths_mm[0])
        CH, CW = np.shape(colors[0])[:2]
        with open(filename, "wb") as f:
            f.write(struct.pack("I", 4))
            name = sensor_name.encode()
            f.write(struct.pack("Q", len(name)))
            f.write(name)
            for mat in (K4, eye, Kd4, eye):
                f.write(struct.pack("f" * 16, *mat.reshape(-1)))
            f.write(struct.pack("i", 2))  # jpeg
            f.write(struct.pack("i", 1))  # zlib_ushort
            f.write(struct.pack("IIII", CW, CH, W, H))
            f.write(struct.pack("f", depth_shift))
            f.write(struct.pack("Q", T))
            for t in range(T):
                color_data = encode_jpeg(np.asarray(colors[t], np.uint8), quality=95)
                depth_data = zlib.compress(np.asarray(depths_mm[t]).astype("<u2").tobytes())
                f.write(struct.pack("f" * 16, *np.asarray(poses[t], np.float32).reshape(-1)))
                f.write(struct.pack("QQQQ", 0, 0, len(color_data), len(depth_data)))
                f.write(color_data)
                f.write(depth_data)
