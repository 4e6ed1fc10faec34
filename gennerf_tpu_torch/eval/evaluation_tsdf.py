"""TSDF-only offline evaluation, no rendering (the port's counterpart of
gennerf_tpu/eval/evaluation_tsdf.py): the masked TSDF L1 of each predicted
volume against its scene's ground truth, written to
{scene}_tsdf_metrics.json.

    python -m gennerf_tpu_torch.eval.evaluation_tsdf --results DIR --dataset val.txt \\
        --data-dir D [--align]
"""
from __future__ import annotations

import argparse
import json
import os

from ..data.datasets import load_info_json, parse_splits_list
from ..tsdf.tsdf import TSDF
from .metrics import eval_tsdf


def process(info_file: str, results_dir: str, align: bool = False) -> dict:
    info = load_info_json(info_file)
    scene = info["scene"]
    voxel_size_cm = min(int(k.rsplit("_", 1)[1]) for k in info if k.startswith("file_name_vol_"))
    pred = TSDF.load(os.path.join(results_dir, f"{scene}.npz"))
    trgt = TSDF.load(info["file_name_vol_%02d" % voxel_size_cm])
    metrics = {"scene": scene}
    metrics.update(eval_tsdf(pred, trgt, align=align))
    with open(os.path.join(results_dir, f"{scene}_tsdf_metrics.json"), "w") as f:
        json.dump(metrics, f, indent=2)
    return metrics


def main(argv=None):
    parser = argparse.ArgumentParser(description="TSDF-L1 evaluation")
    parser.add_argument("--results", required=True)
    parser.add_argument("--dataset", required=True, nargs="+")
    parser.add_argument("--data-dir", default=None)
    parser.add_argument("--align", action="store_true",
                        help="world-align pred to the target grid even at equal shapes "
                        "(default: the reference's direct voxel compare)")
    args = parser.parse_args(argv)
    out = []
    for info_file in parse_splits_list(args.dataset, args.data_dir):
        m = process(info_file, args.results, align=args.align)
        print(json.dumps(m))
        out.append(m)
    return out


if __name__ == "__main__":
    main()
