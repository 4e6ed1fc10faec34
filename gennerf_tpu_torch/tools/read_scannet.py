"""Export raw ScanNet .sens containers to per-frame files or archives
(counterpart of scripts/read_scannet.py): per scene, colour JPEGs, 16-bit
depth PNGs, pose .txt files (each kind tarred with --tar), the intrinsics
and a <scene>.txt of the colour camera's intrinsics and the frame sizes;
a process pool over the scenes.

    python -m gennerf_tpu_torch.tools.read_scannet --path RAW --output OUT
        [--workers 16] [--frame-skip 1] [--tar] [--i I --n N]
"""
from __future__ import annotations

import argparse
import os
from concurrent.futures import ProcessPoolExecutor

from ..data.prepare.sensor_data import SensorData


def export_scene(args_tuple) -> str:
    path, output, scene, frame_skip, use_tar = args_tuple
    folder, scene_name = scene.split("/")
    sens_file = os.path.join(path, folder, scene_name, scene_name + ".sens")
    if not os.path.exists(sens_file):
        print(f"missing {sens_file}, skipping")
        return scene
    out_dir = os.path.join(output, folder, scene_name)
    sd = SensorData(sens_file, archive_result=use_tar)
    sd.export_color_images(os.path.join(out_dir, "color"), frame_skip=frame_skip)
    sd.export_depth_images(os.path.join(out_dir, "depth"), frame_skip=frame_skip)
    sd.export_poses(os.path.join(out_dir, "poses"), frame_skip=frame_skip)
    sd.export_intrinsics(os.path.join(out_dir, "intrinsics"))
    K = sd.intrinsic_color
    with open(os.path.join(out_dir, scene_name + ".txt"), "w") as f:
        f.write(f"fx_color = {K[0, 0]}\nfy_color = {K[1, 1]}\n")
        f.write(f"mx_color = {K[0, 2]}\nmy_color = {K[1, 2]}\n")
        f.write(f"colorWidth = {sd.color_width}\ncolorHeight = {sd.color_height}\n")
        f.write(f"depthWidth = {sd.depth_width}\ndepthHeight = {sd.depth_height}\n")
    return scene


def list_scenes(root: str, i: int = 0, n: int = 1) -> list:
    """'scans/<scene>' and 'scans_test/<scene>' under root, sorted, shard i of n."""
    scenes = []
    for folder in ("scans", "scans_test"):
        d = os.path.join(root, folder)
        if os.path.isdir(d):
            scenes += [os.path.join(folder, s) for s in sorted(os.listdir(d))]
    return scenes[i::n]


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--path", required=True, help="raw scannet root (scans/, scans_test/)")
    parser.add_argument("--output", required=True)
    parser.add_argument("--workers", type=int, default=16)
    parser.add_argument("--frame-skip", type=int, default=1)
    parser.add_argument("--tar", action="store_true", help="archive frames into tars")
    parser.add_argument("--i", type=int, default=0)
    parser.add_argument("--n", type=int, default=1)
    args = parser.parse_args(argv)
    jobs = [(args.path, args.output, s, args.frame_skip, args.tar)
            for s in list_scenes(args.path, args.i, args.n)]
    if args.workers <= 1:
        for job in jobs:
            print("done", export_scene(job))
    else:
        with ProcessPoolExecutor(max_workers=args.workers) as pool:
            for scene in pool.map(export_scene, jobs):
                print("done", scene)


if __name__ == "__main__":
    main()
