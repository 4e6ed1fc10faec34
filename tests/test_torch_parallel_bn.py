"""The port's BatchNorm under data parallelism: 2 ranks (gloo, the CPU)
against one process on the same global batch of 2 scenes.

The JAX package binds no axis name in any norm, but its step is one
jit-global program over a batch-sharded mesh, so every BatchNorm takes its
statistics over the global batch, whichever norm the config names
(tests/test_multidevice.py holds VoxelNet's running statistics on 8
devices to the one-device run's). The port's ranks all-reduce the sums
(parallel.distributed.shared_sum) in every norm of VoxelNet's 3D
encoder-decoder and 2D ResNet ('BN' and 'nnSyncBN') and of the spatial
GenNerf's ResNet (norm_type 'batch' and 'sync_batch'), in float32 and in
bf16-mixed, and in a frame-chunk remat step (frame_chunk 1: the
checkpoint's recompute reduces again in backward).

Sizes: VoxelNet as test_torch_voxelnet.py (resnet18 with 2 layers on 2
frames of 32x32, channels [8, 16, 32], a 16x16x8 volume at 8 cm, heads at
8 and 16 cm); the spatial GenNerf as test_torch_spatial.py's
spatial-only case (resnet18, 2 layers, 2 frames of 24x32).

Tolerances, float32: loss and metrics within 1e-5 relative, every reduced
gradient within 1e-5 of its tensor's largest magnitude, every running
statistic within 1e-5 relative with a floor of 1e-5 of its largest
magnitude (the two-pass global variance sums in another order than
torch's var_mean). bf16-mixed: each statistic and normalization is
float32 under flax's expressions, so the ranks' sums differ from one
process's in float32 rounding only: loss and metrics within 1e-4
relative and running statistics within 1e-5 relative (floor 1e-5 of
max-abs); the gradients within 2e-2 of max-abs, where a float32 difference
in a statistic flips a bf16 rounding in backward now and then (measured:
loss equal, statistics 1.1e-7, gradients 4.8e-3 to 6.3e-3 of max-abs;
float32: loss 6e-8 to 2.4e-7, gradients 1.1e-6 to 3.8e-6, statistics
2.8e-7 to 2.0e-6).
"""
import numpy as np
import pytest
import torch

from gennerf_tpu_torch.data.synthetic import training_batch

import _torch_threads  # noqa: F401  (sizes torch's threads per xdist worker)
from _torch_parallel import run_ranks, run_steps
import _torch_parallel_workers as workers

VD = (16, 16, 8)
VOXELNET = {"type": "VoxelNet", "voxel_size": 0.08, "voxel_dim_train": list(VD),
            "voxel_dim_val": list(VD), "voxel_dim_test": list(VD),
            "encoder": {"use_spatial": True, "use_pointnet": False,
                        "spatial": {"backbone": "resnet18", "num_layers": 2,
                                    "feature_scale": 1.0, "blur_image": False}},
            "backbone3d": {"channels": [8, 16, 32], "layers_down": [1, 2, 3], "layers": [2, 1],
                           "norm": "BN", "conditional_skip": True},
            "heads": {"use_tsdf": True, "tsdf": {"multi_scale": True, "loss_split": "pred"}},
            "optimizer": {"type": "Adam", "lr": 0.001, "weight_decay": 0.0}}
SPATIAL = {
    "type": "GenNerf", "voxel_size": 0.08, "voxel_dim_train": list(VD),
    "voxel_dim_val": list(VD), "voxel_dim_test": list(VD),
    "encoder": {"use_spatial": True, "use_pointnet": False,
                "spatial": {"backbone": "resnet18", "num_layers": 2, "feature_scale": 1.0,
                            "blur_image": False, "norm_type": "batch"}},
    "mlp": {"d_out_sem": 1, "d_out_geo": 8, "n_blocks": 2, "d_hidden": 32, "alpha": 0.7},
    "code": {"num_freqs": 6, "freq_factor": 0.5, "include_input": True},
    "ray": {"num_rays": 16, "N": 5, "M": 3},
    "loss": {"use_tsdf": True, "tsdf": {"weight": 1.0, "transform": "smooth_log",
                                        "shift": 15.0, "smoothness": 10.0}},
    "optimizer": {"type": "Adam", "lr": 0.001, "weight_decay": 0.0001},
}


def _voxelnet(norm):
    return dict(VOXELNET, backbone3d=dict(VOXELNET["backbone3d"], norm=norm))


def _spatial(norm_type, **over):
    enc = dict(SPATIAL["encoder"])
    enc["spatial"] = dict(enc["spatial"], norm_type=norm_type)
    return {**SPATIAL, "encoder": enc, **over}


def _remat(norm_type):
    cfg = _spatial(norm_type, remat=True)
    cfg["encoder"]["spatial"]["frame_chunk"] = 1
    return cfg


CASES = {
    "voxelnet-BN-f32": (_voxelnet("BN"), "32-true", "voxel"),
    "voxelnet-nnSyncBN-f32": (_voxelnet("nnSyncBN"), "32-true", "voxel"),
    "voxelnet-BN-bf16": (_voxelnet("BN"), "bf16-mixed", "voxel"),
    "voxelnet-nnSyncBN-bf16": (_voxelnet("nnSyncBN"), "bf16-mixed", "voxel"),
    "spatial-batch-f32": (_spatial("batch"), "32-true", "frames"),
    "spatial-sync_batch-f32": (_spatial("sync_batch"), "32-true", "frames"),
    "spatial-batch-bf16": (_spatial("batch"), "bf16-mixed", "frames"),
    "spatial-sync_batch-bf16": (_spatial("sync_batch"), "bf16-mixed", "frames"),
    "spatial-sync_batch-remat-f32": (_remat("sync_batch"), "32-true", "frames"),
}


def _batches():
    voxel = training_batch(2, 2, 32, 32, VD, 0.08, seed=3)
    rng = np.random.default_rng(3)
    voxel["vol_16_tsdf"] = np.clip(rng.uniform(-1.3, 1.3, (2, 1, 8, 8, 4)), -1, 1).astype(
        np.float32)
    return {"voxel": voxel, "frames": training_batch(2, 2, 24, 32, VD, 0.08, seed=4)}


@pytest.fixture(scope="module")
def results():
    """{case: (one process, [rank 0, rank 1])}: one train step each (all
    cases on one pair of ranks)."""
    torch.set_num_threads(1)
    batches = _batches()
    cases = [(name, (cfg, precision, None, batches[b]), {"seed": 5})
             for name, (cfg, precision, b) in CASES.items()]
    one = {name: run_steps(*args, **kw) for name, args, kw in cases}
    two = run_ranks(workers.cases_rank, 2, args=(cases,), timeout=600)
    return {name: (one[name], [r[name] for r in two]) for name in CASES}


def _close(ours, ref, atol_rel, name):
    scale = max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(ours, np.float64), np.asarray(ref, np.float64),
                               rtol=0, atol=atol_rel * scale, err_msg=name)


@pytest.mark.parametrize("case", list(CASES))
def test_batchnorm_two_ranks_match_one_process(results, case):
    """Loss, metrics, reduced gradients and every running statistic after
    one step; the ranks' states are bit-equal."""
    one, two = results[case]
    bf16 = CASES[case][1] == "bf16-mixed"
    rel, stat_rel, grad_rel = (1e-4, 1e-5, 2e-2) if bf16 else (1e-5, 1e-5, 1e-5)
    stats = [k for k in one["state"] if "running_" in k]
    assert len(stats) >= 10
    for rank in two:
        for k, v in one["metrics"][0].items():
            assert rank["metrics"][0][k] == pytest.approx(v, rel=rel), k
        for name, g in one["grads"].items():
            if g is not None:
                _close(rank["grads"][name], g, grad_rel, name)
        for k in stats:
            ref = one["state"][k]
            np.testing.assert_allclose(rank["state"][k], ref, rtol=stat_rel,
                                       atol=stat_rel * float(np.abs(ref).max()), err_msg=k)
            assert not np.array_equal(ref, workers.initial_state(CASES[case])[k]), k
    for k, v in two[0]["state"].items():
        np.testing.assert_array_equal(v, two[1]["state"][k], err_msg=k)
