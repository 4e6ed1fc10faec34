"""Offline evaluation of predicted scene reconstructions (the port's
counterpart of gennerf_tpu/eval/evaluation.py).

Per scene: render the predicted mesh at every ground-truth view with the
host library's rasterizer, score the depth (`eval_depth`), re-fuse the
rendered depths with `TSDFFusion` on the given device to trim the surface
the model invents outside the observed space, then the masked TSDF L1 and
the mesh precision / recall / F-score; writes {scene}_metrics.json.

    python -m gennerf_tpu_torch.eval.evaluation --results DIR --dataset val.txt \\
        --data-dir D [--num-frames N] [--max-depth M] [--device cpu]

DIR holds {scene}.npz and {scene}.ply as the predict CLI writes them; the
mean of every metric goes to DIR/metrics_mean.json. The re-fusion runs on
the card unless `--device cpu` is given.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict

import numpy as np
import torch

from ..data.datasets import SceneDataset, parse_splits_list
from ..device import resolve_device
from ..tsdf.fusion import TSDFFusion
from ..tsdf.tsdf import TSDF
from ..utils.mesh import Mesh
from ..utils.native import rasterize_depth
from .metrics import eval_depth, eval_mesh, eval_tsdf


def render_mesh_depth(mesh: Mesh, intrinsics, pose, height: int, width: int) -> np.ndarray:
    """(H, W) z-depth of the mesh at a pinhole view (camera-to-world
    `pose`), 0 where it shows no surface."""
    if mesh.is_empty:
        return np.zeros((height, width), np.float32)
    return rasterize_depth(mesh.vertices, mesh.faces, intrinsics, pose, height, width)


def process(info_file: str, results_dir: str, max_depth: float = 10.0, num_frames: int = -1,
            from_archive: bool = False, device=None) -> Dict:
    """Evaluate one scene (see the module docstring); the ground-truth
    mesh is the scene's mesh_gt.ply, or its fused ground truth meshed when
    that file is absent."""
    device = resolve_device(device)
    dataset = SceneDataset(info_file, frame_types=["depth"], num_frames=num_frames,
                           from_archive=from_archive)
    scene = dataset.info["scene"]
    voxel_size_cm = min(int(k.rsplit("_", 1)[1]) for k in dataset.info
                        if k.startswith("file_name_vol_"))
    voxel_size = voxel_size_cm / 100.0

    pred_tsdf = TSDF.load(os.path.join(results_dir, f"{scene}.npz"))
    pred_mesh = Mesh.load(os.path.join(results_dir, f"{scene}.ply"))
    trgt_tsdf = TSDF.load(dataset.info["file_name_vol_%02d" % voxel_size_cm])
    mesh_gt_path = dataset.info.get("file_name_mesh_gt")
    if mesh_gt_path and os.path.exists(mesh_gt_path):
        trgt_mesh = Mesh.load(mesh_gt_path)
    else:
        if mesh_gt_path:
            print(f"{scene}: GT mesh {mesh_gt_path} absent -> meshing the fused GT TSDF at "
                  f"{voxel_size_cm} cm instead")
        trgt_mesh = trgt_tsdf.get_mesh()

    origin = trgt_tsdf.origin.reshape(3)
    refusion = TSDFFusion(tuple(trgt_tsdf.tsdf_vol.shape), voxel_size, origin, color=False,
                          device=device)
    depth_metrics: Dict[str, float] = {}
    for i in range(len(dataset)):
        frame = dataset[i]
        depth_trgt = np.asarray(frame["depth"], np.float32)
        H, W = depth_trgt.shape
        depth_pred = render_mesh_depth(pred_mesh, frame["intrinsics"], frame["pose"], H, W)
        depth_pred[depth_pred > max_depth] = 0
        for k, v in eval_depth(depth_pred, depth_trgt).items():
            depth_metrics[k] = depth_metrics.get(k, 0.0) + v
        projection = frame["intrinsics"] @ np.linalg.inv(frame["pose"])[:3]
        refusion.integrate(torch.from_numpy(projection.astype(np.float32)).to(device),
                           torch.from_numpy(depth_pred).to(device))
    depth_metrics = {k: v / max(len(dataset), 1) for k, v in depth_metrics.items()}

    # the predicted mesh trimmed to what the re-fused renders observe
    trimmed_mesh = refusion.get_tsdf().get_mesh()
    metrics = {"scene": scene}
    metrics.update(depth_metrics)
    metrics.update(eval_tsdf(pred_tsdf, trgt_tsdf))
    metrics.update(eval_mesh(trimmed_mesh if not trimmed_mesh.is_empty else pred_mesh, trgt_mesh))
    with open(os.path.join(results_dir, f"{scene}_metrics.json"), "w") as f:
        json.dump(metrics, f, indent=2)
    return metrics


def main(argv=None):
    parser = argparse.ArgumentParser(description="full scene evaluation")
    parser.add_argument("--results", required=True, help="dir with {scene}.npz/{scene}.ply")
    parser.add_argument("--dataset", required=True, nargs="+",
                        help="info.json paths or split .txt files")
    parser.add_argument("--data-dir", default=None)
    parser.add_argument("--num-frames", type=int, default=-1)
    parser.add_argument("--max-depth", type=float, default=10.0)
    parser.add_argument("--device", default="cuda", help="device of the re-fusion")
    args = parser.parse_args(argv)

    all_metrics = []
    for info_file in parse_splits_list(args.dataset, args.data_dir):
        m = process(info_file, args.results, args.max_depth, args.num_frames, device=args.device)
        print(json.dumps(m))
        all_metrics.append(m)
    if all_metrics:
        agg = {k: float(np.mean([m[k] for m in all_metrics])) for k in all_metrics[0]
               if isinstance(all_metrics[0][k], (int, float))}
        with open(os.path.join(args.results, "metrics_mean.json"), "w") as f:
            json.dump(agg, f, indent=2)
        print("mean:", json.dumps(agg))
    return all_metrics


if __name__ == "__main__":
    main()
