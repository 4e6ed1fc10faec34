"""Stage a prepared dataset to fast local storage (counterpart of
scripts/staging.py): copy (or untar) each scene of the split files into
the target and rewrite the paths in the staged info.json and split files.

    python -m gennerf_tpu_torch.tools.staging --splits scannet_train.txt --source DATA
        --target $TMPDIR/scannet [--workers 8] [--untar]
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import tarfile
from concurrent.futures import ThreadPoolExecutor


def stage_scene(args_tuple) -> str:
    info_file, source, target, untar = args_tuple
    with open(info_file) as f:
        info = json.load(f)
    rel = os.path.relpath(os.path.dirname(info_file), source)
    dst_dir = os.path.join(target, rel)
    os.makedirs(dst_dir, exist_ok=True)
    src_dir = os.path.dirname(info_file)
    for name in os.listdir(src_dir):
        src = os.path.join(src_dir, name)
        dst = os.path.join(dst_dir, name)
        if os.path.isdir(src):
            os.makedirs(dst, exist_ok=True)
            for fn in os.listdir(src):
                if fn.endswith(".tar") and untar:
                    with tarfile.open(os.path.join(src, fn)) as tar:
                        tar.extractall(dst, filter="data")
                else:
                    shutil.copy2(os.path.join(src, fn), os.path.join(dst, fn))
        elif not os.path.exists(dst):
            shutil.copy2(src, dst)

    def retarget(p):
        return p.replace(source.rstrip("/"), target.rstrip("/")) if isinstance(p, str) else p

    staged = json.loads(json.dumps(info))
    for entry in [staged] + staged["frames"]:
        for key in list(entry):
            if key.startswith("file_name"):
                entry[key] = retarget(entry[key])
    with open(os.path.join(dst_dir, "info.json"), "w") as f:
        json.dump(staged, f)
    return info["scene"]


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--splits", required=True, nargs="+",
                        help="split .txt files (lists of info.json paths)")
    parser.add_argument("--source", required=True)
    parser.add_argument("--target", required=True)
    parser.add_argument("--workers", type=int, default=8)
    parser.add_argument("--untar", action="store_true")
    args = parser.parse_args(argv)
    info_files = []
    for split in args.splits:
        path = split if os.path.exists(split) else os.path.join(args.source, split)
        with open(path) as f:
            info_files += [line.strip() for line in f if line.strip()]
        # the split file itself, retargeted (with the lists read so far, as
        # the reference writes it)
        os.makedirs(args.target, exist_ok=True)
        with open(os.path.join(args.target, os.path.basename(split)), "w") as f:
            for line in info_files:
                f.write(line.replace(args.source.rstrip("/"), args.target.rstrip("/")) + "\n")
    jobs = [(p, args.source, args.target, args.untar) for p in sorted(set(info_files))]
    with ThreadPoolExecutor(max_workers=args.workers) as pool:
        for scene in pool.map(stage_scene, jobs):
            print("staged", scene)


if __name__ == "__main__":
    main()
