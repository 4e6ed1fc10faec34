"""Split a list file into N parts <base>_XX<ext> (counterpart of
scripts/split_files.py), to shard preparation jobs.

    python -m gennerf_tpu_torch.tools.split_files --input list.txt --n 4
"""
from __future__ import annotations

import argparse
import os


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--input", required=True)
    parser.add_argument("--n", type=int, required=True)
    args = parser.parse_args(argv)
    with open(args.input) as f:
        lines = [line.rstrip() for line in f if line.strip()]
    base, ext = os.path.splitext(args.input)
    for i in range(args.n):
        part = lines[i::args.n]
        out = f"{base}_{i:02d}{ext}"
        with open(out, "w") as f:
            f.write("\n".join(part) + "\n")
        print(f"{out}: {len(part)} entries")


if __name__ == "__main__":
    main()
