"""Unpack exported per-scene archives to working storage (counterpart of
scripts/build_scannet.py): the from_archive=False layout, tars extracted
and other files copied, a process pool over the scenes.

    python -m gennerf_tpu_torch.tools.build_scannet --source EXPORT --target LOCAL
        [--workers 16] [--i I --n N]
"""
from __future__ import annotations

import argparse
import os
import shutil
import tarfile
from concurrent.futures import ProcessPoolExecutor

from .read_scannet import list_scenes


def build_scene(args_tuple) -> str:
    source, target, scene = args_tuple
    src_dir = os.path.join(source, scene)
    dst_dir = os.path.join(target, scene)
    os.makedirs(dst_dir, exist_ok=True)
    for name in os.listdir(src_dir):
        src = os.path.join(src_dir, name)
        dst = os.path.join(dst_dir, name)
        if os.path.isdir(src):
            os.makedirs(dst, exist_ok=True)
            for fn in os.listdir(src):
                p = os.path.join(src, fn)
                if fn.endswith(".tar"):
                    with tarfile.open(p) as tar:
                        tar.extractall(dst, filter="data")
                else:
                    shutil.copy2(p, os.path.join(dst, fn))
        elif not os.path.exists(dst):
            shutil.copy2(src, dst)
    return scene


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--source", required=True)
    parser.add_argument("--target", required=True)
    parser.add_argument("--workers", type=int, default=16)
    parser.add_argument("--i", type=int, default=0)
    parser.add_argument("--n", type=int, default=1)
    args = parser.parse_args(argv)
    jobs = [(args.source, args.target, s) for s in list_scenes(args.source, args.i, args.n)]
    if args.workers <= 1:
        for job in jobs:
            print("built", build_scene(job))
    else:
        with ProcessPoolExecutor(max_workers=args.workers) as pool:
            for scene in pool.map(build_scene, jobs):
                print("built", scene)


if __name__ == "__main__":
    main()
