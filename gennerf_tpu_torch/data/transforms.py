"""Host-side preprocessing transforms (counterpart of
gennerf_tpu/data/transforms.py).

Frames hold numpy arrays from the PNG decoder instead of PIL images: the
image as (H, W, 3) uint8 until `ToArray` makes it (3, H, W) float32, depth
as (H, W) float32 meters. The resizes reproduce PIL's (utils/image.py).
The 3D resample inside `TransformSpace` is `TSDF.transform`, numpy on the
host.
"""
from __future__ import annotations

import numpy as np

from ..utils.image import resize_bilinear, resize_nearest


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


class ToArray:
    """Images to (3, H, W) float32 (0-255, as the reference's ToTensor of a
    PIL image leaves them), the other frame arrays to float32."""

    def __call__(self, data):
        for frame in data["frames"]:
            frame["image"] = np.asarray(frame["image"], np.float32).transpose(2, 0, 1)
            frame["intrinsics"] = np.asarray(frame["intrinsics"], np.float32)
            frame["pose"] = np.asarray(frame["pose"], np.float32)
            if "depth" in frame:
                frame["depth"] = np.asarray(frame["depth"], np.float32)
            if "instance" in frame:
                frame["instance"] = np.asarray(frame["instance"], np.int64)
        return data


class IntrinsicsPoseToProjection:
    """projection = K @ pose^-1[:3]."""

    def __call__(self, data):
        for frame in data["frames"]:
            K = np.asarray(frame["intrinsics"], np.float32)
            pose = np.asarray(frame["pose"], np.float32)
            frame["projection"] = (K @ np.linalg.inv(pose)[:3]).astype(np.float32)
        return data


def pad_scannet(frame):
    """1296x968 -> 1296x972 (4:3) by 2 black rows above and below."""
    h, w = frame["image"].shape[:2]
    if w == 1296 and h == 968:
        frame["image"] = np.pad(frame["image"], ((2, 2), (0, 0), (0, 0)))
        frame["intrinsics"][1, 2] += 2
        if frame.get("instance") is not None:
            frame["instance"] = np.pad(frame["instance"], ((2, 2), (0, 0)))
    return frame


class ResizeImage:
    """Resize images bilinearly and depth (and instances) nearest, and
    rescale the intrinsics; `size` is (width, height)."""

    def __init__(self, size):
        self.size = size

    def __call__(self, data):
        for frame in data["frames"]:
            pad_scannet(frame)
            h, w = frame["image"].shape[:2]
            frame["image"] = resize_bilinear(frame["image"], self.size)
            frame["intrinsics"][0, :] /= w / self.size[0]
            frame["intrinsics"][1, :] /= h / self.size[1]
            if "depth" in frame:
                frame["depth"] = resize_nearest(frame["depth"], self.size)
            if frame.get("instance") is not None:
                frame["instance"] = resize_nearest(frame["instance"], self.size)
        return data

    def __repr__(self):
        return f"ResizeImage(size={self.size})"


def transform_space(data, transform: np.ndarray, voxel_dim, origin):
    """Apply a 4x4 world-frame transform to the poses and every TSDF volume
    ('vol_XX' keys), each resampled onto voxel_dim scaled to its voxel size."""
    inv = np.linalg.inv(np.asarray(transform, np.float64)).astype(np.float32)
    for frame in data["frames"]:
        frame["pose"] = (inv @ np.asarray(frame["pose"], np.float32)).astype(np.float32)
    voxel_sizes = [int(key[4:]) for key in data if key[:3] == "vol"]
    matrix = np.asarray(transform, np.float32)
    for voxel_size in voxel_sizes:
        scale = voxel_size / min(voxel_sizes)
        vd = [int(v / scale) for v in voxel_dim]
        key = "vol_%02d" % voxel_size
        data[key] = data[key].transform(matrix, vd, origin)
    return data


class TransformSpace:
    def __init__(self, transform, voxel_dim, origin):
        self.transform = np.asarray(transform, np.float32)
        self.voxel_dim = voxel_dim
        self.origin = origin

    def __call__(self, data):
        return transform_space(data, self.transform, self.voxel_dim, self.origin)


class RandomTransformSpace:
    """A random z-rotation and a random crop translation of the world
    frame, applied to the poses and the ground truth: the 3D augmentation.
    The rotation is drawn first, then the translation, from `rng`."""

    def __init__(self, voxel_dim, random_rotation=True, random_translation=True,
                 paddingXY=1.5, paddingZ=0.25, origin=(0, 0, 0), rng=None):
        self.voxel_dim = voxel_dim
        self.origin = list(origin)
        self.random_rotation = random_rotation
        self.random_translation = random_translation
        self.padding_start = np.array([paddingXY, paddingXY, paddingZ], np.float32)
        self.padding_end = np.array([paddingXY, paddingXY, 0], np.float32)
        self.rng = rng or np.random.default_rng()

    def __call__(self, data):
        voxel_sizes = [int(key[4:]) for key in data if key[:3] == "vol"]
        if not voxel_sizes:
            return data
        tsdf = data["vol_%02d" % min(voxel_sizes)]

        r = self.rng.random() * 2 * np.pi if self.random_rotation else 0.0
        R = np.array([[np.cos(r), -np.sin(r)], [np.sin(r), np.cos(r)]], np.float32)

        dims = np.array(tsdf.tsdf_vol.shape, np.float32) * tsdf.voxel_size
        origin = np.asarray(tsdf.origin).reshape(3)
        xmin, ymin, zmin = origin
        xmax, ymax, zmax = origin + dims
        corners2d = R @ np.array([[xmin, xmin, xmax, xmax], [ymin, ymax, ymin, ymax]], np.float32)
        xmin, xmax = corners2d[0].min(), corners2d[0].max()
        ymin, ymax = corners2d[1].min(), corners2d[1].max()

        start = np.array([xmin, ymin, zmin], np.float32) - self.padding_start
        end = (-np.asarray(self.voxel_dim, np.float32) * tsdf.voxel_size
               + np.array([xmax, ymax, zmax], np.float32) + self.padding_end)
        t = self.rng.random(3).astype(np.float32) if self.random_translation else 0.5
        t = t * start + (1 - t) * end

        T = np.eye(4, dtype=np.float32)
        T[:2, :2] = R
        T[:3, 3] = -t
        return transform_space(data, np.linalg.inv(T).astype(np.float32), self.voxel_dim, self.origin)


class FlattenTSDF:
    """TSDF objects to flat 'vol_XX_tsdf' (1, nx, ny, nz) arrays (and one
    'vol_XX_<attr>' array per attribute volume) for collation."""

    def __call__(self, data):
        for key in list(data.keys()):
            if key[:3] == "vol" and not key.endswith("_tsdf"):
                tsdf = data.pop(key)
                data["vol_" + key[4:] + "_tsdf"] = tsdf.tsdf_vol.cpu().numpy()[None]
                for attr, vol in tsdf.attribute_vols.items():
                    data["vol_" + key[4:] + "_" + attr] = vol.cpu().numpy()
        return data
