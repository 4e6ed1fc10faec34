"""A raw ScanNet scene made from a synthetic room: a 'rooms' scene of
data/synthetic.py (a room shell with box, cylinder and sphere furniture)
seen by cameras inside it, rendered at ScanNet's sizes (colour 1296x968,
depth 640x480 in millimetres) with ScanNet-like intrinsics and written as
<out>/scans/<scene>/<scene>.sens by the port's writer (JPEG colour at
quality 95, zlib depth). The depth camera is the colour camera as the
loaders see it at 640x480 (after the 2-row pad of 1296x968 to 1296x972),
so the prepared frames line up exactly.

    python -m gennerf_tpu_torch.data.prepare.synthetic_scannet --out RAW
        [--scene scene0244_01] [--frames 48] [--distinct N] [--seed 0] [--threads 8]

--distinct renders that many views and cycles them over the frames (a
long scene for timing without rendering every frame).
"""
from __future__ import annotations

import argparse
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..synthetic import look_at_pose, random_primitives, render_scene, room_camera
from .sensor_data import SensorData

COLOR_K = np.array([[1170.19, 0.0, 647.75], [0.0, 1170.19, 483.75], [0.0, 0.0, 1.0]], np.float32)
COLOR_SIZE, DEPTH_SIZE = (968, 1296), (480, 640)  # (height, width)


def depth_intrinsics(K_color: np.ndarray) -> np.ndarray:
    """The colour camera at 640x480 after the loaders' 2-row pad."""
    K = np.asarray(K_color, np.float64).copy()
    K[1, 2] += 2
    K[0] *= DEPTH_SIZE[1] / COLOR_SIZE[1]
    K[1] *= DEPTH_SIZE[0] / (COLOR_SIZE[0] + 4)
    return K.astype(np.float32)


def room_poses(primitives, num_frames: int, seed: int = 0) -> np.ndarray:
    """(num_frames, 4, 4) camera-to-world poses on the room camera ring of
    generate_scene (angle and height jittered), aimed across the room."""
    rng = np.random.default_rng(seed)
    radius, height, target = room_camera(primitives, 2.2, 1.3, np.array([0.0, 0.0, 0.4]))
    poses = []
    for i in range(num_frames):
        ang = 2 * np.pi * i / num_frames + 0.01 * rng.standard_normal()
        eye = np.array([radius * np.cos(ang), radius * np.sin(ang),
                        height + 0.05 * rng.standard_normal()])
        poses.append(look_at_pose(eye, target))
    return np.stack(poses)


def render_views(primitives, poses, threads: int = 8):
    """(depth mm (n, 480, 640) uint16, colour (n, 968, 1296, 3) uint8) of
    each pose, rendered by `threads` threads."""
    Kd = depth_intrinsics(COLOR_K)

    def one(pose):
        depth, _ = render_scene(*DEPTH_SIZE, Kd, pose, primitives=primitives)
        _, color = render_scene(*COLOR_SIZE, COLOR_K, pose, primitives=primitives)
        return (depth * 1000).astype(np.uint16), color

    with ThreadPoolExecutor(max(1, threads)) as pool:
        frames = list(pool.map(one, poses))
    return np.stack([f[0] for f in frames]), np.stack([f[1] for f in frames])


class _Cycle:
    """frames[t % len(frames)] over `n` frames."""

    def __init__(self, frames, n: int):
        self.frames, self.n = frames, n

    def __len__(self):
        return self.n

    def __getitem__(self, t):
        return self.frames[t % len(self.frames)]


def write_scene(out: str, scene: str = "scene0244_01", num_frames: int = 48, seed: int = 0,
                distinct: int = None, threads: int = 8) -> dict:
    """Render and write the scene's .sens under out/scans/<scene>/. Returns
    the path, the primitives, the distinct views' poses, depths (mm) and
    colours, and the seconds of the render and of the write."""
    distinct = num_frames if distinct is None else min(distinct, num_frames)
    primitives = random_primitives(np.random.default_rng(seed), "rooms")
    poses = room_poses(primitives, distinct, seed)
    t0 = time.perf_counter()
    depths, colors = render_views(primitives, poses, threads)
    render_s = time.perf_counter() - t0
    scene_dir = os.path.join(out, "scans", scene)
    os.makedirs(scene_dir, exist_ok=True)
    path = os.path.join(scene_dir, scene + ".sens")
    t0 = time.perf_counter()
    SensorData.write(path, COLOR_K, _Cycle(depths, num_frames), _Cycle(colors, num_frames),
                     _Cycle(poses, num_frames), intrinsic_depth=depth_intrinsics(COLOR_K),
                     sensor_name="synthetic room")
    return {"sens": path, "primitives": primitives, "poses": poses, "depth_mm": depths,
            "color": colors, "render_s": render_s, "write_s": time.perf_counter() - t0}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="write a synthetic room as a raw ScanNet .sens")
    parser.add_argument("--out", required=True)
    parser.add_argument("--scene", default="scene0244_01")
    parser.add_argument("--frames", type=int, default=48)
    parser.add_argument("--distinct", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--threads", type=int, default=8)
    args = parser.parse_args(argv)
    rec = write_scene(args.out, args.scene, args.frames, args.seed, args.distinct, args.threads)
    print(rec["sens"], f"render {rec['render_s']:.1f} s, write {rec['write_s']:.1f} s")
    return rec


if __name__ == "__main__":
    main()
