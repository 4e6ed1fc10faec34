"""ScannetDataModule: the dataset choice, the per-mode transform chains and
the loaders (counterpart of gennerf_tpu/data/datamodule.py).

The loaders are map-style iterators whose items load on a thread pool
(zlib, numpy and torch release the interpreter lock while they decode and
resample) and whose batches assemble and yield strictly in order. Every
random draw of an item comes from a generator seeded by (the mode's seed,
the item's serial), so a batch depends neither on `num_workers` nor on
thread scheduling, and the draws equal the JAX package's.

Under data parallelism (`world` ranks) each rank's loader decodes only its
rows [r*k, (r+1)*k) of every global batch, each item keeping its global
serial, so the ranks' batches put together are the one-process batch bit
for bit (the shuffle is the same on every rank). A batch whose rows the
ranks do not divide (a final partial batch) is decoded whole on every
rank. A rank's batches carry `shard`: whether they hold its rows (True)
or the whole batch (False).
"""
from __future__ import annotations

import queue
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np

from ..parallel.distributed import local_batch_slice, process_index
from . import transforms as T
from .datasets import (
    FrameDataset, ItemCache, OneSceneDataset, ScenesDataset, ScenesSequencesDataset, collate_fn,
    parse_splits_list,
)


class LockedGenerator:
    """A thread-safe proxy of an np.random.Generator. Inside
    `item_scope(seed)` a thread draws from its own Generator seeded by
    `seed`; outside a scope draws come from the shared Generator under a
    lock."""

    def __init__(self, rng: np.random.Generator):
        self._rng = rng
        self._lock = threading.Lock()
        self._local = threading.local()

    def item_scope(self, seed):
        """Context manager binding this thread's draws to
        np.random.default_rng(seed)."""
        proxy = self

        class _Scope:
            def __enter__(self):
                proxy._local.rng = np.random.default_rng(seed)

            def __exit__(self, *exc):
                proxy._local.rng = None

        return _Scope()

    def __getattr__(self, name):
        local_rng = getattr(self._local, "rng", None)
        if local_rng is not None:
            return getattr(local_rng, name)
        fn = getattr(self._rng, name)
        if not callable(fn):
            return fn
        lock = self._lock

        def locked(*a, **k):
            with lock:
                return fn(*a, **k)

        return locked


class DataLoader:
    """Shuffle, batch, collate; with num_workers > 0 the items of the next
    PREFETCH batches load concurrently on a thread pool.

    With `item_rng`, each item runs under item_rng.item_scope((seed,
    serial)), `serial` counting items in submission order across epochs.
    With `world` > 1 it yields rank `rank`'s rows of each batch (module
    docstring); serials count the global batch's items."""

    PREFETCH = 2

    def __init__(self, dataset, batch_size=1, shuffle=False, seed=0, num_workers=4,
                 item_rng: Optional[LockedGenerator] = None, world: int = 1, rank: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.item_rng = item_rng
        self.world, self.rank = int(world), int(rank)
        self._serial = 0

    def _jobs(self, chunk: List[int]):
        """(zero-argument loaders of this rank's items of a batch, whether
        they are its rows); the serials are taken now, in submission order,
        whichever thread runs them later."""
        first = self._serial
        self._serial += len(chunk)
        take, split = slice(0, len(chunk)), False
        if self.world > 1 and len(chunk) % self.world == 0:
            take, split = local_batch_slice(len(chunk), self.world, self.rank), True
        return [self._job(chunk[j], first + j)
                for j in range(len(chunk))[take]], split

    def _collate(self, items, split: bool):
        batch = collate_fn(items)
        if self.world > 1:
            batch["shard"] = split
        return batch

    def _job(self, i: int, serial: int):
        """A zero-argument loader of item i under its serial's draws."""
        if self.item_rng is None:
            return lambda: self.dataset[i]

        def job():
            with self.item_rng.item_scope((self.seed, serial)):
                return self.dataset[i]

        return job

    def __len__(self):
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def _index_batches(self):
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(idx)
        for s in range(0, len(idx), self.batch_size):
            yield [int(i) for i in idx[s:s + self.batch_size]]

    def __iter__(self):
        if self.num_workers <= 0:
            for chunk in self._index_batches():
                jobs, split = self._jobs(chunk)
                yield self._collate([job() for job in jobs], split)
            return
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending: "queue.SimpleQueue" = queue.SimpleQueue()
            chunks = self._index_batches()
            in_flight = 0
            def submit(chunk):
                jobs, split = self._jobs(chunk)
                pending.put(([pool.submit(job) for job in jobs], split))

            for chunk in chunks:
                submit(chunk)
                in_flight += 1
                if in_flight >= self.PREFETCH + 1:
                    break
            while in_flight:
                futures, split = pending.get()
                in_flight -= 1
                batch = self._collate([f.result() for f in futures], split)
                nxt = next(chunks, None)
                if nxt is not None:
                    submit(nxt)
                    in_flight += 1
                yield batch


class ScannetDataModule:
    """Datasets and loaders of a `data` config for each mode. `num_devices`
    is the data-parallel world size (the batch size must be a multiple of
    it); the train, val and test loaders then yield rank `rank`'s rows
    (default: this process's rank in the process group)."""

    def __init__(self, cfg: Dict, num_devices: int = 1, seed: int = 0,
                 rank: Optional[int] = None):
        self.cfg = dict(cfg)
        self.seed = seed
        self.world = max(int(num_devices), 1)
        if rank is None:
            rank = process_index() if self.world > 1 else 0
        self.rank = int(rank)
        c = self.cfg
        self.voxel_size = c["voxel_size"]
        self.voxel_types = c.get("voxel_types", ["tsdf"])
        layers_down = c.get("layers_down")
        base = int(self.voxel_size * 100)
        self.voxel_sizes = ([base * 2**i for i in range(len(layers_down) - 1)] if layers_down
                            else [base])
        self.frame_types = ["depth"]
        cache = c.get("cache_items", False)
        self.cache = None
        if cache:
            self.cache = ItemCache(frames=2048 if cache is True else int(cache),
                                   volumes=int(c.get("cache_volumes", 64)))
        if c.get("batch_size", 1) % max(num_devices, 1) != 0:
            raise ValueError(f"batch_size {c.get('batch_size')} not divisible by devices {num_devices}")

    def get_transform(self, mode: str, rng=None):
        """Resize to 640x480, arrays, the space transform (random in
        'train' when the config asks, centered otherwise), the flat volumes
        and the projections."""
        c = self.cfg
        voxel_dim = {"train": c["voxel_dim_train"], "val": c["voxel_dim_val"],
                     "test": c["voxel_dim_test"]}[mode]
        train = mode == "train"
        return T.Compose([
            T.ResizeImage((640, 480)),
            T.ToArray(),
            T.RandomTransformSpace(
                voxel_dim,
                random_rotation=train and c.get("random_rotation_3d", False),
                random_translation=train and c.get("random_translation_3d", False),
                paddingXY=c.get("pad_xy_3d", 0.0), paddingZ=c.get("pad_z_3d", 0.0), rng=rng),
            T.FlattenTSDF(),
            T.IntrinsicsPoseToProjection(),
        ])

    def _info_files(self, mode: str) -> List[str]:
        return parse_splits_list(self.cfg[f"datasets_{mode}"], self.cfg.get("data_dir"))

    def mode_seed(self, mode: str) -> int:
        """The seed of a mode's draws: the run seed plus crc32(mode) % 1000."""
        return self.seed + zlib.crc32(mode.encode()) % 1000

    def choose_dataset(self, mode: str):
        """The mode's dataset (`dataset_type`), drawing from a
        LockedGenerator of the mode's seed, which it returns too."""
        c = self.cfg
        rng = LockedGenerator(np.random.default_rng(self.mode_seed(mode)))
        common = dict(transform=self.get_transform(mode, rng), frame_types=self.frame_types,
                      voxel_types=self.voxel_types, voxel_sizes=self.voxel_sizes,
                      from_archive=c.get("from_archive", False), cache=self.cache)
        dtype = c.get("dataset_type", "sequences")
        if dtype == "sequences":
            ds = ScenesSequencesDataset(
                self._info_files(mode), sequence_amount=c[f"sequence_amount_{mode}"],
                sequence_length=c["sequence_length"], sequence_locations=c["sequence_locations"],
                sequence_order=c["sequence_order"], num_frames=c[f"num_frames_{mode}"],
                frame_locations=c["frame_locations"], frame_order=c["frame_order"], rng=rng,
                **common)
        elif dtype == "scenes":
            ds = ScenesDataset(
                self._info_files(mode), num_frames=c[f"num_frames_{mode}"],
                frame_locations=c.get("frame_selection", "evenly_spaced"),
                frame_order=c.get("frame_order", "sorted"), rng=rng, **common)
        elif dtype == "frame":
            ds = FrameDataset(self._info_files(mode), frame_idx=c["frame_idx"],
                              length=c[f"length_{mode}"], scene_idx=c.get("scene_idx", 0), **common)
        elif dtype == "scene":
            ds = OneSceneDataset(self._info_files(mode)[c.get("scene_idx", 0)],
                                 frames=c[f"frames_{mode}"], **common)
        else:
            raise NotImplementedError(f"dataset_type {dtype}")
        return ds, rng

    def _loader(self, mode: str, shuffle: bool) -> DataLoader:
        ds, rng = self.choose_dataset(mode)
        return DataLoader(ds, batch_size=self.cfg.get("batch_size", 1), shuffle=shuffle,
                          seed=self.mode_seed(mode),
                          num_workers=self.cfg.get(f"num_workers_{mode}",
                                                   self.cfg.get("num_workers", 4)),
                          item_rng=rng, world=self.world, rank=self.rank)

    def train_dataloader(self) -> DataLoader:
        return self._loader("train", self.cfg.get("shuffle_train", True))

    def val_dataloader(self) -> DataLoader:
        return self._loader("val", self.cfg.get("shuffle_val", False))

    def test_dataloader(self) -> DataLoader:
        return self._loader("test", self.cfg.get("shuffle_test", False))

    def predict_dataloader(self) -> DataLoader:
        """The test split through ScenesDataset's inference path, one scene
        a batch. Its frame draws come from the run seed (the reference
        leaves that generator unseeded)."""
        c = self.cfg
        ds = ScenesDataset(
            self._info_files("test"), num_frames=c.get("num_frames_test", -1),
            frame_locations=c.get("frame_selection", "evenly_spaced"),
            frame_order=c.get("frame_order", "sorted"), transform=None,
            frame_types=self.frame_types, voxel_types=self.voxel_types,
            voxel_sizes=self.voxel_sizes, from_archive=c.get("from_archive", False),
            voxel_dim=c["voxel_dim_test"], rng=np.random.default_rng(self.seed), cache=self.cache)
        return DataLoader(ds, batch_size=1, shuffle=False, seed=self.seed)
