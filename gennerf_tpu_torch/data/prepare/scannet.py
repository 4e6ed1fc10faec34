"""ScanNet metadata: exported scene directories -> info.json and split
files (counterpart of gennerf_tpu/data/prepare/scannet.py)."""
from __future__ import annotations

import json
import os

import numpy as np

REPO_SPLITS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))),
    "splits")


def prepare_scannet_scene(scene: str, path: str, path_meta: str, verbose: int = 1) -> str:
    """Write path_meta/<scene>/info.json for one scene and return its path.

    scene: e.g. 'scans/scene0000_00' or 'scans_test/scene0708_00'; path:
    the exported ScanNet root (color/, depth/, poses/ and <scene>.txt per
    scene); path_meta: the output root, mirroring path's layout. Frames with
    a non-finite pose are left out; every frame carries the colour
    camera's intrinsics (the loaders resize depth to match)."""
    if verbose > 0:
        print(f"preparing {scene}")
    folder, scene_name = scene.split("/")
    data = {
        "dataset": "scannet",
        "path": path_meta,
        "scene": scene_name,
        "file_name_mesh_gt": os.path.join(path_meta, folder, scene_name,
                                          scene_name + "_vh_clean_2.ply"),
        "frames": [],
    }
    with open(os.path.join(path, folder, scene_name, f"{scene_name}.txt")) as f:
        info = dict(line.rstrip().split(" = ") for line in f if " = " in line)
    intrinsics = [[float(info["fx_color"]), 0, float(info["mx_color"])],
                  [0, float(info["fy_color"]), float(info["my_color"])],
                  [0, 0, 1]]
    frame_ids = sorted(int(os.path.splitext(fn)[0])
                       for fn in os.listdir(os.path.join(path, folder, scene_name, "color"))
                       if not fn.endswith(".tar"))
    for i, frame_id in enumerate(frame_ids):
        if verbose > 1 and i % 25 == 0:
            print(f"preparing {scene_name} frame {i}/{len(frame_ids)}")
        pose = np.loadtxt(os.path.join(path, folder, scene_name, "poses", f"{frame_id}.txt"))
        if not np.all(np.isfinite(pose)):
            continue
        data["frames"].append({
            "file_name_image": os.path.join(path_meta, folder, scene_name, "color", f"{frame_id}.jpg"),
            "file_name_image_temp": os.path.join(path, folder, scene_name, "color", f"{frame_id}.jpg"),
            "file_name_depth": os.path.join(path_meta, folder, scene_name, "depth", f"{frame_id}.png"),
            "file_name_depth_temp": os.path.join(path, folder, scene_name, "depth", f"{frame_id}.png"),
            "intrinsics": intrinsics,
            "pose": pose.tolist(),
        })
    os.makedirs(os.path.join(path_meta, folder, scene_name), exist_ok=True)
    out = os.path.join(path_meta, folder, scene_name, "info.json")
    with open(out, "w") as f:
        json.dump(data, f)
    return out


SPLITS = (
    ("scannet_train.txt", "scans", "scannetv2_train.txt"),
    ("scannet_val.txt", "scans", "scannetv2_val.txt"),
    ("scannet_test.txt", "scans_test", "scannetv2_test.txt"),
    ("scannet_living_train.txt", "scans", "scannetv2_living_train.txt"),
    ("scannet_living_val.txt", "scans", "scannetv2_living_val.txt"),
    ("scannet_living_test.txt", "scans", "scannetv2_living_test.txt"),
)


def prepare_scannet_splits(path: str, path_meta: str, splits_dir: str = None) -> None:
    """Write path_meta/scannet_*.txt: the info.json path of every scene of
    the official scannetv2 lists and the living-room subsets, each list
    read from `splits_dir` (default: the repository's splits/), else from
    `path`; a list found in neither is skipped."""
    splits_dir = REPO_SPLITS if splits_dir is None else splits_dir
    os.makedirs(path_meta, exist_ok=True)
    for name, folder, fname in SPLITS:
        src = os.path.join(splits_dir, fname)
        if not os.path.exists(src):
            src = os.path.join(path, fname)
        if not os.path.exists(src):
            continue
        with open(src) as f:
            scenes = sorted(line.rstrip() for line in f if line.strip())
        with open(os.path.join(path_meta, name), "w") as out_file:
            for scene in scenes:
                out_file.write(os.path.join(path_meta, folder, scene, "info.json") + "\n")
