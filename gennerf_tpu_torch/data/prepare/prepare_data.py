"""Ground-truth TSDFs of prepared ScanNet scenes by depth and colour fusion
(counterpart of gennerf_tpu/data/prepare/prepare_data.py). The volume's
bounds come from quantiles of the back-projected depth of at most 200
evenly spaced frames (plus a margin); every frame is then fused at each
voxel size on `device`, the frames decoded and resized by loader threads
while the device fuses.

    python -m gennerf_tpu_torch.data.prepare.prepare_data --path RAW --path_meta OUT
        [--i I --n N] [--test] [--max_depth 3.0] [--skip_existing] [--verbose 1]
        [--device cuda]
"""
from __future__ import annotations

import argparse
import collections
import itertools
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import transforms as T
from ..datasets import SceneDataset, load_info_json
from ...ops.projection import depth_to_world
from ...tsdf.fusion import TSDFFusion
from .scannet import prepare_scannet_scene, prepare_scannet_splits

LOADER_THREADS = min(8, os.cpu_count() or 1)


def update_info_json(info_file: str, voxel_size: int, file_name_vol: str) -> None:
    data = load_info_json(info_file)
    data["file_name_vol_%02d" % voxel_size] = file_name_vol
    with open(info_file, "w") as f:
        json.dump(data, f)


def clean_info(scene: str, path_meta: str) -> None:
    """Drop the export-side frame paths from the scene's info.json."""
    info_file = os.path.join(path_meta, scene, "info.json")
    data = load_info_json(info_file)
    for frame in data["frames"]:
        frame.pop("file_name_image_temp", None)
        frame.pop("file_name_depth_temp", None)
    with open(info_file, "w") as f:
        json.dump(data, f)


def prefetch(dataset, indices, threads: int = LOADER_THREADS):
    """dataset[i] for i in indices, in order, loaded ahead by `threads`
    threads (the JPEG codec and numpy release the GIL)."""
    indices = iter(indices)
    with ThreadPoolExecutor(threads) as pool:
        pending = collections.deque(pool.submit(dataset.__getitem__, int(i))
                                    for i in itertools.islice(indices, 2 * threads))
        while pending:
            frame = pending.popleft().result()
            nxt = next(indices, None)
            if nxt is not None:
                pending.append(pool.submit(dataset.__getitem__, int(nxt)))
            yield frame


def scene_frames(info_file: str, from_archive: bool = False) -> SceneDataset:
    """The scene's frames as fusion reads them: colour padded (1296x968 ->
    1296x972) and reduced to 640x480, depth at 640x480, the projection."""
    transform = T.Compose([T.ResizeImage((640, 480)), T.ToArray(), T.IntrinsicsPoseToProjection()])
    return SceneDataset(info_file, transform, frame_types=["depth"], from_archive=from_archive)


def frame_tensors(frame: dict, max_depth: float, device):
    """(projection (3, 4), depth (H, W) with depth beyond max_depth set to
    0, image (3, H, W)) float32 tensors of a `scene_frames` item on device."""
    depth = np.asarray(frame["depth"], np.float32)
    depth = np.where(depth > max_depth, 0.0, depth).astype(np.float32)
    return (torch.from_numpy(frame["projection"]).to(device), torch.from_numpy(depth).to(device),
            torch.from_numpy(np.asarray(frame["image"], np.float32)).to(device))


def fuse_scene(path_meta: str, scene: str, voxel_sizes, trunc_ratio: float = 3,
               max_depth: float = 3.0, vol_prcnt: float = 0.995, vol_margin: float = 1.5,
               verbose: int = 2, skip_existing: bool = False, from_archive: bool = False,
               device="cuda") -> dict:
    """Fuse the scene's depth and colour frames into tsdf_XX.npz and
    mesh_XX.ply at each of `voxel_sizes` cm, all fused in one pass over the
    frames (the bounds do not depend on the voxel size), and record each
    volume in info.json. Frames are resized to 640x480
    (colour padded 1296x968 -> 1296x972 first) and depth beyond max_depth
    dropped. Returns the seconds of each stage."""
    sizes = [int(v) for v in voxel_sizes]
    info_file = os.path.join(path_meta, scene, "info.json")
    names = {vs: (os.path.join(path_meta, scene, "tsdf_%02d.npz" % vs),
                  os.path.join(path_meta, scene, "mesh_%02d.ply" % vs)) for vs in sizes}
    if skip_existing:
        for vs in list(sizes):
            if all(os.path.exists(p) for p in names[vs]):
                update_info_json(info_file, vs, names[vs][0])
                sizes.remove(vs)
    timings = {}
    if not sizes:
        return timings
    if verbose > 0:
        print(f"fusing {scene} voxel size {', '.join(map(str, sizes))}")
    dataset = scene_frames(info_file, from_archive)

    # pass 1: the volume's bounds from <= 200 evenly spaced frames
    t0 = time.perf_counter()
    inds = (range(len(dataset)) if len(dataset) <= 200
            else np.linspace(0, len(dataset) - 1, 200).astype(int))
    pts = []
    for frame in prefetch(dataset, inds):
        projection, depth, _ = frame_tensors(frame, max_depth, device)
        p = depth_to_world(projection, depth).T
        pts.append(p[depth.reshape(-1) > 0].cpu().numpy())
    pts = np.concatenate(pts)
    pts = pts[np.isfinite(pts[:, 0])]
    origin = np.quantile(pts, 1 - vol_prcnt, axis=0) - vol_margin
    vol_max = np.quantile(pts, vol_prcnt, axis=0) + vol_margin
    timings["bounds_s"] = time.perf_counter() - t0

    # pass 2: every frame into each voxel size's fusion
    t0 = time.perf_counter()
    fusions = {}
    for vs_cm in sizes:
        vs = float(vs_cm) / 100
        vol_dim = tuple(((vol_max - origin) / vs).astype(int).tolist())
        fusions[vs_cm] = TSDFFusion(vol_dim, vs, tuple(origin.astype(np.float32)), trunc_ratio,
                                    color=True, device=device)
    for i, frame in enumerate(prefetch(dataset, range(len(dataset)))):
        if verbose > 1 and i % 25 == 0:
            print(f"{scene} integrating voxel size {sizes} {i}/{len(dataset)}")
        tensors = frame_tensors(frame, max_depth, device)
        for fusion in fusions.values():
            fusion.integrate(*tensors)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    timings["fuse_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    for vs_cm, fusion in fusions.items():
        tsdf = fusion.get_tsdf()
        tsdf.save(names[vs_cm][0])
        tsdf.get_mesh().export(names[vs_cm][1])
        update_info_json(info_file, vs_cm, names[vs_cm][0])
    timings["write_s"] = time.perf_counter() - t0
    return timings


def prepare_scannet(path: str, path_meta: str, i: int = 0, n: int = 1, test_only: bool = False,
                    max_depth: float = 3.0, skip_existing: bool = False, verbose: int = 2,
                    voxel_sizes=(4, 8, 16), device="cuda") -> dict:
    """Prepare shard `i` of `n` of the exported dataset at `path` into
    `path_meta`: the split files (shard 0), then per scene info.json, the
    fused volumes at `voxel_sizes` on `device` and the cleaned info.json.
    Returns {scene: seconds of its stages}."""
    scenes = []
    if not test_only:
        scenes += sorted(os.path.join("scans", s) for s in os.listdir(os.path.join(path, "scans")))
    if os.path.isdir(os.path.join(path, "scans_test")):
        scenes += sorted(os.path.join("scans_test", s)
                         for s in os.listdir(os.path.join(path, "scans_test")))
    scenes = scenes[i::n]
    if i == 0:
        prepare_scannet_splits(path, path_meta)
    timings = {}
    for scene in scenes:
        t0 = time.perf_counter()
        prepare_scannet_scene(scene, path, path_meta, verbose)
        info_s = time.perf_counter() - t0
        timings[scene] = {"info_s": info_s, **fuse_scene(
            path_meta, scene, voxel_sizes, max_depth=max_depth, skip_existing=skip_existing,
            verbose=verbose, device=device)}
        clean_info(scene, path_meta)
    return timings


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="Fuse ground truth TSDF on ScanNet")
    parser.add_argument("--path", required=True)
    parser.add_argument("--path_meta", required=True)
    parser.add_argument("--i", default=0, type=int)
    parser.add_argument("--n", default=1, type=int)
    parser.add_argument("--test", action="store_true")
    parser.add_argument("--max_depth", default=3.0, type=float)
    parser.add_argument("--skip_existing", action="store_true")
    parser.add_argument("--verbose", default=1, type=int)
    parser.add_argument("--device", default="cuda", help="where fusion runs (cuda or cpu)")
    args = parser.parse_args(argv)
    if not 0 <= args.i < args.n:
        parser.error("need 0 <= --i < --n")
    return prepare_scannet(os.path.expandvars(args.path), os.path.expandvars(args.path_meta),
                           args.i, args.n, args.test, args.max_depth, args.skip_existing,
                           args.verbose, device=args.device)


if __name__ == "__main__":
    main()
