"""A tiny copy of a configuration and a CPU context, for the CPU tests."""
from __future__ import annotations

import copy
import time

import torch

from portbench import run
from portbench.core import spec

TINY_GENNERF = {
    "num_frames": 2, "frame_height": 24, "frame_width": 32, "batch_size": 2,
    "voxel_size": 0.2, "voxel_dim_train": [16, 16, 8], "voxel_dim_test": [16, 16, 8],
    "ground_truth_cm": [20],
}


def tiny_gennerf(cfg: dict) -> dict:
    c = copy.deepcopy(cfg)
    c.update(copy.deepcopy(TINY_GENNERF))
    m = c["model"]
    m.update(voxel_size=c["voxel_size"], voxel_dim_train=c["voxel_dim_train"],
             voxel_dim_val=c["voxel_dim_test"], voxel_dim_test=c["voxel_dim_test"])
    pn = m["encoder"]["pointnet"]
    pn.update(fps_presample=128, num_sparse_points=16, plane_resolution=16, c_dim=8,
              hidden_dim=8, n_blocks=3, unet_kwargs={"depth": 2, "merge_mode": "concat",
                                                    "start_filts": 8})
    m["mlp"].update(d_hidden=32, n_blocks=2, d_out_geo=8)
    m["ray"].update(num_rays=8, N=4, M=2)
    m["code"].update(num_freqs=2)
    return c


TINY_VOXELNET = {
    "num_frames": 4, "frame_height": 24, "frame_width": 32, "batch_size": 2,
    "voxel_size": 0.2, "voxel_dim_train": [16, 16, 8], "voxel_dim_test": [16, 16, 8],
    "ground_truth_cm": [20, 40, 80],
}


def tiny_voxelnet(cfg: dict) -> dict:
    c = copy.deepcopy(cfg)
    c.update(copy.deepcopy(TINY_VOXELNET))
    m = c["model"]
    m.update(voxel_size=c["voxel_size"], voxel_dim_train=c["voxel_dim_train"],
             voxel_dim_val=c["voxel_dim_test"], voxel_dim_test=c["voxel_dim_test"])
    m["encoder"]["spatial"].update(num_layers=2, frame_chunk=2)
    m["backbone3d"].update(channels=[8, 16, 32, 64], layers=[1, 1, 1])
    return c


def tiny(cfg: dict) -> dict:
    return tiny_voxelnet(cfg) if cfg["model"]["type"] == "VoxelNet" else tiny_gennerf(cfg)


# cells whose pieces are ready but that BENCHMARK.json does not hold yet
STANDBY = [{"name": "gennerf_living.train", "config": "gennerf_living", "traffic": "train_pool",
            "chips": 1, "why": "GenNerf training steps (not a benchmark cell: see PERF.md)"}]


def cpu_ctx(cell: str, seed: int = 7, seconds: float = 0.5, trace: bool = False) -> run.Ctx:
    bench = spec.load_benchmark()
    names = {w["name"] for w in bench["workloads"]}
    bench["workloads"] += [w for w in STANDBY if w["name"] not in names]
    ctx = run.Ctx(bench, cell, seed, seconds, trace, torch.device("cpu"), t0=time.perf_counter())
    ctx.cfg = tiny(ctx.cfg)
    ctx.traffic = copy.deepcopy(ctx.traffic)
    ctx.traffic["pool"] = max(2, ctx.traffic.get("compared", 0))
    ctx.traffic["warmup"] = 1
    return ctx
