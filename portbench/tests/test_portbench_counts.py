"""The FLOP counts of counts/<config>.py against torch's FlopCounterMode on
the plain reference at a small size."""
import json
import math
import os

import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.core import spec
from portbench.counts import gennerf_living as counts
from portbench.reference import gennerf_living as ref
from portbench.tests.tiny import tiny_gennerf


def _cfg():
    with open(os.path.join(spec.PKG, "configs", "gennerf_living.json")) as f:
        return tiny_gennerf(json.load(f))


def _weights(cfg):
    from portbench.core import port

    _, w = port.build(cfg["model"], "32-true", "cpu", 3)
    return w


def _counted(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_request_flops_match_the_reference_forward():
    cfg = _cfg()
    W = _weights(cfg)
    a = ref.Arith()
    n = cfg["num_frames"] * cfg["model"]["encoder"]["pointnet"]["num_sparse_points"]
    pts = torch.rand(1, n, 3) - 0.5
    planes = ref.encode_planes(a, W, cfg, pts)
    assert _counted(lambda: ref.encode_planes(a, W, cfg, pts)) == counts.encode_flops(cfg, 1)
    grid = ref.dense_points(cfg["voxel_dim_test"], cfg["voxel_size"], "cpu")[None]
    decoded = _counted(lambda: ref.decode(a, W, cfg, planes, grid))
    assert decoded == grid.shape[1] * counts.decode_point_flops(cfg)
    assert counts.request_flops(cfg) == counts.encode_flops(cfg, 1) + decoded


def test_step_flops_match_the_reference_forward_and_backward():
    from portbench.core import scenes

    cfg = _cfg()
    W = {k: v.clone().requires_grad_(True) for k, v in _weights(cfg).items()}
    gen = torch.Generator().manual_seed(5)
    B, T, H, Wd = cfg["batch_size"], cfg["num_frames"], cfg["frame_height"], cfg["frame_width"]
    batch = scenes.training_batch(gen, B, T, H, Wd, cfg["voxel_dim_train"], cfg["voxel_size"],
                                  {"xy_frac": [0.8, 0.9], "height_frac": [0.8, 0.9], "boxes": 2,
                                   "box_xy_m": [0.3, 0.6], "box_h_m": [0.3, 0.6],
                                   "ring_frac": 0.4, "arc_turns": 0.75, "eye_m": [0.8, 1.0]},
                                  "cpu")
    ray = cfg["model"]["ray"]
    draws = {"scores": torch.rand(B * T, H * Wd, generator=gen),
             "noise": torch.randn(B * T, ray["num_rays"], ray["M"], generator=gen)}
    n = cfg["model"]["encoder"]["pointnet"]["num_sparse_points"]
    pts = torch.rand(B * T, n, 3) - 0.5
    rays = _counted(lambda: ref.ray_points(cfg, batch, draws))  # camera to world, not the model's
    forward = _counted(lambda: ref.train_loss(ref.Arith(), W, cfg, batch, draws, pts)) - rays
    both = _counted(lambda: ref.train_loss(ref.Arith(), W, cfg, batch, draws, pts).backward()) - rays
    assert 3 * forward == counts.step_flops(cfg)
    # the convention of three forwards: the backward skips only the input
    # gradients of the layers fed by data (the points, the positional code)
    assert 0.97 * counts.step_flops(cfg) <= both <= counts.step_flops(cfg)


def test_voxelnet_step_flops_match_the_reference():
    from portbench.core import port, scenes
    from portbench.counts import voxelnet_living as vcounts
    from portbench.reference import voxelnet_living as vref
    from portbench.tests.tiny import tiny_voxelnet

    with open(os.path.join(spec.PKG, "configs", "voxelnet_living.json")) as f:
        cfg = tiny_voxelnet(json.load(f))
    _, W0 = port.build(cfg["model"], "32-true", "cpu", 4, train=True)
    W = {k: v.clone().requires_grad_(True) for k, v in W0.items() if "running_" not in k}
    stats = {k: v.clone() for k, v in W0.items() if "running_" in k}
    gen = torch.Generator().manual_seed(6)
    B, T, H, Wd = cfg["batch_size"], cfg["num_frames"], cfg["frame_height"], cfg["frame_width"]
    batch = scenes.training_batch(gen, B, T, H, Wd, cfg["voxel_dim_train"], cfg["voxel_size"],
                                  {"xy_frac": [0.8, 0.9], "height_frac": [0.8, 0.9], "boxes": 2,
                                   "box_xy_m": [0.3, 0.6], "box_h_m": [0.3, 0.6],
                                   "ring_frac": 0.4, "arc_turns": 0.75, "eye_m": [0.8, 1.0]},
                                  "cpu", cfg["ground_truth_cm"])
    with torch.no_grad():
        forward = _counted(lambda: vref.train_loss(vref.Net(W, dict(stats), ref.Arith()), cfg,
                                                   batch))
    # the reference projects each stage map before its resize: the model's
    # 1x1 projection of the concatenated maps at the stem's size, less that
    sp = cfg["model"]["encoder"]["spatial"]
    h, w = int(H * sp["feature_scale"]) // 2, int(Wd * sp["feature_scale"]) // 2
    out = cfg["model"]["backbone3d"]["channels"][0]
    maps = [(64, h * w), (256, ((h + 1) // 2) * ((w + 1) // 2))][:sp["num_layers"]]
    model_proj = 2 * sum(c for c, _ in maps) * out * h * w
    ref_proj = sum(2 * c * out * px for c, px in maps)
    frames = B * T
    projections = T * B * 2 * 3 * 4 * math.prod(cfg["voxel_dim_train"])  # the voxel centres'
    assert forward - projections == vcounts.step_flops(cfg) / 3 - frames * (model_proj - ref_proj)
