"""Write the multi-geometry synthetic dataset of the 4 cm quality drive
(counterpart of scripts/local/make_multigeo_dataset.py): `--train` scenes
cycled over the geometry families, then one held-out scene per family,
fused at 4 and 8 cm, with train.txt, val.txt and splits.json. The seed
stream is the reference's, so the scenes are the same.

    python -m gennerf_tpu_torch.data.make_multigeo --out DIR [--train 8] [--frames 10]
        [--height 120] [--width 160] [--voxel-sizes 4 8] [--families spheres,boxes]

Numpy and torch on the CPU; the frames are PNGs without line filters.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List

import numpy as np

from .synthetic import generate_scene, random_primitives


def make_multigeo(out: str, train: int = 8, frames: int = 10, height: int = 120,
                  width: int = 160, voxel_sizes=(4, 8), families=("spheres", "boxes"),
                  verbose: bool = False) -> Dict[str, List[str]]:
    """Write the dataset under `out`; returns the split lists (info.json
    paths relative to `out`)."""
    rng = np.random.default_rng(0)
    splits: Dict[str, List[str]] = {"train": [], "val": []}
    scenes = [(f"scene_{families[i % len(families)][:-1]}{i}", families[i % len(families)], i)
              for i in range(train)]
    scenes += [(f"scene_heldout_{family[:-1]}", family, 100 + fi)
               for fi, family in enumerate(families)]
    for n, (name, family, seed) in enumerate(scenes):
        info = generate_scene(out, scene=name, num_frames=frames, H=height, W=width,
                              voxel_sizes=tuple(voxel_sizes),
                              primitives=random_primitives(rng, family), seed=seed)
        splits["train" if n < train else "val"].append(os.path.relpath(info, out))
        if verbose:
            print("train:" if n < train else "heldout:", info, flush=True)
    with open(os.path.join(out, "splits.json"), "w") as f:
        json.dump(splits, f, indent=2)
    for split, infos in splits.items():
        with open(os.path.join(out, f"{split}.txt"), "w") as f:
            f.write("\n".join(infos) + "\n")
    return splits


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", required=True)
    parser.add_argument("--train", type=int, default=8)
    parser.add_argument("--frames", type=int, default=10)
    parser.add_argument("--height", type=int, default=120)
    parser.add_argument("--width", type=int, default=160)
    parser.add_argument("--voxel-sizes", type=int, nargs="+", default=[4, 8])
    parser.add_argument("--families", default="spheres,boxes",
                        help="comma list of geometry families to cycle "
                             "(spheres|boxes|cylinders|mixed|rooms)")
    args = parser.parse_args(argv)
    make_multigeo(args.out, args.train, args.frames, args.height, args.width,
                  args.voxel_sizes, tuple(args.families.split(",")), verbose=True)
    print("splits at", os.path.join(args.out, "{train,val}.txt"))


if __name__ == "__main__":
    main()
