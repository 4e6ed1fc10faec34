"""Dataset readers over the canonical ScanNet layout: info.json, frames as
PNG or JPEG files or in tar archives, tsdf_XX.npz ground truth (counterpart of
gennerf_tpu/data/datasets.py).

Host-side numpy: frames decode through the port's PNG reader and JPEG
codec (utils/image.py) into arrays, by file extension (ScanNet's colour
frames are .jpg, the multigeo dataset's .png); ground truth loads as
`TSDF` on the CPU.
"""
from __future__ import annotations

import json
import os
import tarfile
import threading
import warnings
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..tsdf.tsdf import TSDF
from ..utils.image import decode_jpeg, decode_png
from . import transforms as T

DEPTH_SHIFT = 1000.0


class BlobCache:
    """Thread-safe LRU of decoded blobs (capacity 0: off). Hits return the
    stored object; callers copy what they mutate."""

    def __init__(self, capacity: int = 0):
        self.cap = int(capacity)
        self._d: "OrderedDict[str, object]" = OrderedDict()
        self._lock = threading.Lock()

    def get(self, key):
        with self._lock:
            if self.cap <= 0 or key not in self._d:
                return None
            self._d.move_to_end(key)
            return self._d[key]

    def put(self, key, val) -> None:
        with self._lock:
            if self.cap <= 0:
                return
            self._d[key] = val
            self._d.move_to_end(key)
            while len(self._d) > self.cap:
                self._d.popitem(last=False)


class ItemCache:
    """The decoded-frame and ground-truth-volume caches of one data module
    (the reference's `cache_items`): the same decoded bytes either way."""

    def __init__(self, frames: int = 0, volumes: int = 0):
        self.frames = BlobCache(frames)
        self.volumes = BlobCache(volumes)


def load_info_json(json_file: str) -> dict:
    with open(json_file) as f:
        return json.load(f)


def _decode(path: str, raw: bytes, is_depth: bool) -> np.ndarray:
    if path.lower().endswith((".jpg", ".jpeg")):
        img = decode_jpeg(raw)
    elif path.lower().endswith(".png"):
        img = decode_png(raw)
    else:
        raise NotImplementedError(f"{path}: the port decodes PNG and JPEG frames")
    return img.astype(np.float32) / DEPTH_SHIFT if is_depth else img


def _read_frame_files(frames_data: List[dict], frame_types, from_archive: bool,
                      cache: Optional[ItemCache]) -> None:
    """Decode each frame's image (and depth) into the dicts, through the
    frame cache, opening each tar archive once."""
    kinds = [("file_name_image", "image", False)]
    if "depth" in frame_types:
        kinds.append(("file_name_depth", "depth", True))
    for key, out_key, is_depth in kinds:
        misses = []
        for data in frames_data:
            hit = cache.frames.get(data[key]) if cache else None
            if hit is not None:
                data[out_key] = hit.copy()
            else:
                misses.append(data)
        if not misses:
            continue
        if from_archive:
            dir_path = os.path.dirname(misses[0][key])
            tar_path = os.path.join(dir_path, os.path.basename(dir_path) + ".tar")
            with tarfile.open(tar_path, "r") as tar_file:
                raws = [tar_file.extractfile(tar_file.getmember(os.path.basename(d[key]))).read()
                        for d in misses]
        else:
            raws = []
            for d in misses:
                with open(d[key], "rb") as f:
                    raws.append(f.read())
        for data, raw in zip(misses, raws):
            data[out_key] = _decode(data[key], raw, is_depth)
            if cache:
                cache.frames.put(data[key], data[out_key].copy())


def map_frames(frames: List[dict], frame_ids, frame_types=(), from_archive=True,
               cache: Optional[ItemCache] = None) -> List[dict]:
    """The frames `frame_ids` of a scene with their images, depth (meters,
    when asked for), intrinsics and pose as arrays."""
    frames_data = [dict(frames[i]) for i in frame_ids]
    _read_frame_files(frames_data, frame_types, from_archive, cache)
    for data in frames_data:
        data["intrinsics"] = np.array(data["intrinsics"], dtype=np.float32)
        data["pose"] = np.array(data["pose"], dtype=np.float32)
    return frames_data


def map_frame(frame: dict, frame_types: Sequence[str] = (), from_archive: bool = True,
              cache: Optional[ItemCache] = None) -> dict:
    """One frame (see map_frames)."""
    return map_frames([frame], [0], frame_types, from_archive, cache)[0]


def map_tsdf(info: dict, data: dict, voxel_types, voxel_sizes,
             cache: Optional[ItemCache] = None) -> dict:
    """Add the ground-truth volumes `vol_XX` (XX the voxel size in cm) as
    CPU `TSDF`s; the cache keeps the loaded arrays, each access gets its
    own TSDF."""
    if len(voxel_types) > 0:
        for scale in voxel_sizes:
            fname = info["file_name_vol_%02d" % scale]
            key = f"{fname}|{','.join(sorted(voxel_types))}"
            vol = cache.volumes.get(key) if cache else None
            if vol is None:
                vol = TSDF.load(fname, list(voxel_types))
                if cache:
                    cache.volumes.put(key, vol)
            data["vol_%02d" % scale] = TSDF(vol.voxel_size, vol.origin.clone(),
                                            vol.tsdf_vol.clone(),
                                            {k: v.clone() for k, v in vol.attribute_vols.items()})
    return data


def parse_splits_list(splits, data_dir: Optional[str] = None) -> List[str]:
    """Expand split .txt files and .json paths into info.json paths; a
    relative path resolves against `data_dir`."""
    if isinstance(splits, str):
        splits = splits.split()
    info_files: List[str] = []
    for split in splits:
        if data_dir and not (os.path.isabs(split) and os.path.exists(split)):
            split_path = os.path.join(data_dir, split.lstrip("/"))
        else:
            split_path = split
        ext = os.path.splitext(split)[1]
        if ext == ".json":
            info_files.append(split_path)
        elif ext == ".txt":
            with open(split_path) as f:
                lines = [line.strip() for line in f if line.strip()]
            info_files += [line if os.path.isabs(line) or not data_dir
                           else os.path.join(data_dir, line) for line in lines]
        else:
            raise NotImplementedError(f"{split} not a valid info_file type")
    return info_files


def _find_first_higher_index(lst, val):
    for i, x in enumerate(lst):
        if x > val:
            return i
    return None


class _Dataset:
    """What every dataset shares: the transform, the frame and voxel types
    to load, the archive flag and the item cache."""

    def __init__(self, transform=None, frame_types=(), voxel_types=(), voxel_sizes=(),
                 from_archive=True, cache: Optional[ItemCache] = None):
        self.transform = transform
        self.frame_types = frame_types
        self.voxel_types = voxel_types
        self.voxel_sizes = voxel_sizes
        self.from_archive = from_archive
        self.cache = cache

    def _item(self, info: dict, frame_ids, scene=None) -> dict:
        frames = map_frames(info["frames"], frame_ids, self.frame_types, self.from_archive,
                            self.cache)
        data = {"dataset": info["dataset"], "scene": scene, "frames": frames}
        return map_tsdf(info, data, self.voxel_types, self.voxel_sizes, self.cache)


class SceneDataset(_Dataset):
    """Per-frame dataset over one scene (data preparation, offline eval)."""

    def __init__(self, info_file, transform=None, frame_types=(), voxel_types=(),
                 voxel_sizes=(), num_frames=-1, from_archive=True, cache=None):
        super().__init__(transform, frame_types, voxel_types, voxel_sizes, from_archive, cache)
        self.info = load_info_json(info_file)
        if num_frames > -1:
            inds = np.linspace(0, len(self.info["frames"]) - 1, num_frames, dtype=int)
            self.info["frames"] = [self.info["frames"][i] for i in inds]

    def __len__(self):
        return len(self.info["frames"])

    def __getitem__(self, i):
        frame = map_frame(self.info["frames"][i], self.frame_types, self.from_archive, self.cache)
        data = {"dataset": self.info["dataset"], "frames": [frame]}
        if self.transform is not None:
            data = self.transform(data)
        return data["frames"][0]

    def get_tsdf(self):
        data = map_tsdf(self.info, {"dataset": self.info["dataset"], "frames": []},
                        self.voxel_types, self.voxel_sizes, self.cache)
        return self.transform(data) if self.transform is not None else data


class ScenesDataset(_Dataset):
    """Scene -> N frames + TSDF. Without a transform this is the inference
    path: the scene moves by an origin `offset` (the ground truth's origin
    less 0.5 m rounded down to whole voxels, or (0, 0, -0.5) without
    ground truth), and the ground truth is resampled onto `voxel_dim` in
    that frame."""

    def __init__(self, info_files, num_frames, frame_locations, frame_order, transform=None,
                 frame_types=(), voxel_types=(), voxel_sizes=(), from_archive=True,
                 voxel_dim=None, rng=None, cache=None):
        super().__init__(transform, frame_types, voxel_types, voxel_sizes, from_archive, cache)
        self.info_files = list(info_files)
        self.num_frames = num_frames
        self.frame_locations = frame_locations
        self.frame_order = frame_order
        self.voxel_dim = voxel_dim
        self.rng = rng or np.random.default_rng()

    def __len__(self):
        return len(self.info_files)

    def get_frame_ids(self, info):
        length = len(info["frames"])
        num_frames = length if (self.num_frames == -1 or self.num_frames > length) else self.num_frames
        if self.frame_locations == "random":
            return self.rng.integers(0, length, size=num_frames)
        if self.frame_locations == "evenly_spaced":
            idxs = np.linspace(0, length - 1, num_frames, dtype=int)
            self.rng.shuffle(idxs)
            return idxs
        raise NotImplementedError(f"frame_locations: {self.frame_locations}")

    def __getitem__(self, i):
        info = load_info_json(self.info_files[i])
        frame_ids = self.get_frame_ids(info)
        if self.frame_order == "sorted":
            frame_ids = np.sort(frame_ids)
        elif self.frame_order != "random":
            raise NotImplementedError(f"frame_order: {self.frame_order}")
        data = self._item(info, frame_ids, info["scene"])
        if self.transform is not None:
            return self.transform(data)

        voxel_scale = self.voxel_sizes[0] if self.voxel_sizes else None
        if voxel_scale is not None and ("vol_%02d" % voxel_scale) in data:
            voxel_size = float(voxel_scale) / 100
            shift = np.array([0.5, 0.5, 0.5]) // voxel_size
            origin = np.asarray(data["vol_%02d" % voxel_scale].origin).reshape(3)
            offset = origin - shift * voxel_size
        else:
            offset = np.array([0.0, 0.0, -0.5])
        data["offset"] = offset.reshape(1, 3).astype(np.float32)
        mat = np.eye(4, dtype=np.float32)
        mat[:3, 3] = offset
        return T.Compose([
            T.ResizeImage((640, 480)),
            T.ToArray(),
            T.TransformSpace(mat, self.voxel_dim, [0, 0, 0]),
            T.FlattenTSDF(),
            T.IntrinsicsPoseToProjection(),
        ])(data)


class ScenesSequencesDataset(_Dataset):
    """Scene -> sequence windows -> frames. The window starts of every
    scene are drawn from `rng` at construction; each item draws its frame
    ids inside its window."""

    def __init__(self, info_files, sequence_amount, sequence_length, sequence_locations,
                 sequence_order, num_frames, frame_locations, frame_order, transform=None,
                 frame_types=(), voxel_types=(), voxel_sizes=(), from_archive=True, rng=None,
                 cache=None):
        super().__init__(transform, frame_types, voxel_types, voxel_sizes, from_archive, cache)
        self.info_files = list(info_files)
        self.sequence_amount = sequence_amount
        self.sequence_length = sequence_length
        self.sequence_locations = sequence_locations
        self.sequence_order = sequence_order
        self.num_frames = num_frames
        self.frame_locations = frame_locations
        self.frame_order = frame_order
        self.rng = rng or np.random.default_rng()

        start_idxs_list, num_sequences_list, drop = [], [], []
        for i, info_file in enumerate(self.info_files):
            n = len(load_info_json(info_file)["frames"])
            num_sequences = int(self.sequence_amount * (n / self.sequence_length))
            if n < self.sequence_length:
                drop.append(i)
                continue
            if num_sequences == 0:
                warnings.warn(
                    f"{info_file}: sequence_amount={self.sequence_amount} x ({n} frames / "
                    f"{self.sequence_length} window) floors to ZERO windows", stacklevel=2)
            num_sequences_list.append(num_sequences)
            start_idxs = self.calculate_start_idxs(n, num_sequences)
            if self.sequence_order == "sorted":
                start_idxs = np.sort(start_idxs)
            elif self.sequence_order != "random":
                raise NotImplementedError(f"sequence_order: {self.sequence_order}")
            start_idxs_list.append(start_idxs)
        for i in sorted(drop, reverse=True):
            del self.info_files[i]
        self.num_sequences_list = num_sequences_list
        self.start_idxs_list = start_idxs_list

    def calculate_start_idxs(self, num_scene_frames, num_sequences):
        if self.sequence_locations == "free":
            n = num_scene_frames - self.sequence_length + 1
            return self.rng.choice(n, num_sequences, replace=False)
        if self.sequence_locations == "fixed":
            n = num_scene_frames // self.sequence_length
            return self.rng.choice(n, num_sequences, replace=False) * self.sequence_length
        if self.sequence_locations == "evenly_spaced":
            if num_sequences == 1:
                idxs = np.array([(num_scene_frames - self.sequence_length) // 2])
            else:
                idxs = np.linspace(0, num_scene_frames - self.sequence_length,
                                   num=num_sequences).astype(int)
            self.rng.shuffle(idxs)
            return idxs
        raise NotImplementedError(f"sequence_locations: {self.sequence_locations}")

    def get_indices(self, item_idx):
        cum = np.cumsum(self.num_sequences_list)
        scene_idx = _find_first_higher_index(cum, item_idx)
        prev = 0 if scene_idx == 0 else cum[scene_idx - 1]
        return scene_idx, item_idx - prev

    def get_frame_ids(self, scene_idx, sequence_idx):
        low = self.start_idxs_list[scene_idx][sequence_idx]
        high = low + self.sequence_length
        if self.frame_locations == "random":
            return self.rng.choice(np.arange(low, high), self.num_frames, replace=False)
        if self.frame_locations == "evenly_spaced":
            idxs = np.linspace(low, high - 1, num=self.num_frames).astype(int)
            self.rng.shuffle(idxs)
            return idxs
        raise NotImplementedError(f"frame_locations: {self.frame_locations}")

    def __len__(self):
        return int(sum(self.num_sequences_list))

    def __getitem__(self, i):
        if i < 0:
            raise IndexError(i)
        scene_idx, sequence_idx = self.get_indices(i)
        info = load_info_json(self.info_files[scene_idx])
        frame_ids = self.get_frame_ids(scene_idx, sequence_idx)
        if self.frame_order == "sorted":
            frame_ids = np.sort(frame_ids)
        elif self.frame_order != "random":
            raise NotImplementedError(f"frame_order: {self.frame_order}")
        data = self._item(info, frame_ids, info["scene"])
        return self.transform(data) if self.transform is not None else data


class FrameDataset(_Dataset):
    """One frame repeated `length` times (an overfit fixture)."""

    def __init__(self, info_files, frame_idx, length, scene_idx=0, transform=None,
                 frame_types=(), voxel_types=(), voxel_sizes=(), from_archive=True, cache=None):
        super().__init__(transform, frame_types, voxel_types, voxel_sizes, from_archive, cache)
        self.info = load_info_json(info_files[scene_idx])
        self.frame_idx = frame_idx
        self.length = length

    def __len__(self):
        return self.length

    def __getitem__(self, i):
        data = self._item(self.info, [self.frame_idx], self.info["scene"])
        return self.transform(data) if self.transform is not None else data


class OneSceneDataset(_Dataset):
    """Fixed frame ids of one scene, one frame an item."""

    def __init__(self, info_file, transform=None, frame_types=(), voxel_types=(),
                 voxel_sizes=(), frames=(), from_archive=True, cache=None):
        super().__init__(transform, frame_types, voxel_types, voxel_sizes, from_archive, cache)
        self.info = load_info_json(info_file)
        self.info["frames"] = [self.info["frames"][i] for i in frames]

    def __len__(self):
        return len(self.info["frames"])

    def __getitem__(self, i):
        data = self._item(self.info, [i], self.info.get("scene"))
        return self.transform(data) if self.transform is not None else data

    def get_tsdf(self):
        data = map_tsdf(self.info, {"dataset": self.info["dataset"], "frames": []},
                        self.voxel_types, self.voxel_sizes, self.cache)
        return self.transform(data) if self.transform is not None else data


def collate_fn(data_list: List[dict]) -> Dict[str, np.ndarray]:
    """Items into a batch: arrays stacked to (B, ...) and frame arrays to
    (B, T, ...); other values as lists."""
    keys = [k for k in data_list[0].keys() if k != "frames"]
    frame_keys = list(data_list[0]["frames"][0].keys()) if data_list[0]["frames"] else []
    out: Dict[str, list] = {key: [] for key in keys + frame_keys}
    for data in data_list:
        for key in keys:
            out[key].append(data[key])
        for key in frame_keys:
            if isinstance(data["frames"][0][key], np.ndarray):
                out[key].append(np.stack([frame[key] for frame in data["frames"]]))
            else:
                out[key].append([frame.get(key) for frame in data["frames"]])
    for key in list(out.keys()):
        if out[key] and isinstance(out[key][0], np.ndarray):
            out[key] = np.stack(out[key])
    return out
