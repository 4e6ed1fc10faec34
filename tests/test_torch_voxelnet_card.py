"""VoxelNet on the card against the CPU (torch only: run on the card's
machine with `python -m pytest --noconftest -q tests/test_torch_voxelnet_card.py`).

The drive config (configs/experiment/seqs_multigeo_voxelnet.yaml) at full
width from a seeded init with every BatchNorm randomized, on a synthetic
scene of 8 frames of 240x320 (a 480x640 ResNet input) with the ground
truth at 4 and 8 cm on the 80x80x40 training grid.

Tolerances, float32 with TF32 off, eval mode: the encode's observation
counts equal on 99.99% of the voxels and the volume within 1e-4 of its
largest magnitude on 99.9% of its entries (a voxel centre that projects
within float32 noise of a pixel boundary reads the neighbouring pixel in
one of the two: 0.011% of the entries on the H100 for this scene); the refine of
one and the same volume on both: the losses within 1e-5 relative, 99.99%
of each output's voxels within 1e-4 of its largest magnitude (cuDNN and
the CPU sum each convolution in another order; a voxel whose coarse
prediction lies within that noise of the sparse threshold may take the
other branch). bf16-mixed, eval mode: the card's outputs no further from
the CPU's float32 outputs than 1.5 times the CPU's bf16 outputs are (mean
absolute difference over the volume): the two bf16 paths round to bf16 at
the same places, but a different summation order moves some values
across a rounding boundary, and the flips spread through the layers, so
the card is as far from float32 as the CPU's bf16 path is, not nearer to
it.
"""
import os

import numpy as np
import pytest
import torch

from gennerf_tpu_torch.data.synthetic import training_batch
from gennerf_tpu_torch.models.config import VoxelNetConfig, config_from_dict
from gennerf_tpu_torch.models.voxel_net import VoxelNet
from gennerf_tpu_torch.utils.config import load_experiment_model_config

import _torch_threads  # noqa: F401  (sizes torch's threads per xdist worker)

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "configs", "experiment", "seqs_multigeo_voxelnet.yaml")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _model_and_batch():
    cfg = config_from_dict(VoxelNetConfig, load_experiment_model_config(CONFIG))
    torch.manual_seed(0)
    state = VoxelNet(cfg).state_dict()
    g = torch.Generator().manual_seed(1)
    for k, v in state.items():
        if k.endswith(("running_var", "bn1.weight", "bn2.weight", "norm.weight")):
            v.copy_(0.5 + torch.rand(v.shape, generator=g))
        elif k.endswith(("running_mean", "bn1.bias", "bn2.bias", "norm.bias")):
            v.copy_(0.1 * torch.randn(v.shape, generator=g))
    dims = tuple(cfg.voxel_dim_train)
    b = training_batch(1, 8, 240, 320, dims, 0.04, seed=3)
    b["vol_08_tsdf"] = training_batch(1, 8, 24, 32, tuple(d // 2 for d in dims), 0.08,
                                      seed=3)["vol_08_tsdf"]
    return cfg, state, {k: torch.from_numpy(v) for k, v in b.items()}


def _model(cfg, state, device, dtype):
    model = VoxelNet(cfg, dtype=dtype)
    model.load_state_dict(state)
    return model.to(device).eval()


def _targets(batch, device):
    return {k: batch[k].to(device) for k in ("vol_04_tsdf", "vol_08_tsdf")}


def _forward(cfg, state, batch, device, dtype):
    with torch.no_grad():
        out, losses = _model(cfg, state, device, dtype)(
            batch["projection"].to(device), batch["image"].to(device), cfg.voxel_dim_train, None,
            _targets(batch, device))
    return ({k: v.float().cpu() for k, v in out.items()},
            {k: float(v) for k, v in losses.items()})


def _share_within(ours, ref, tol):
    return float(((ours - ref).abs() <= tol * ref.abs().max()).float().mean())


@pytest.mark.cuda
def test_float32_forward_on_the_card_matches_the_cpu(cuda):
    cfg, state, batch = _model_and_batch()
    cpu = torch.device("cpu")
    reprs = {}
    for device in (cuda, cpu):
        with torch.no_grad():
            r = _model(cfg, state, device, torch.float32).encode(
                batch["projection"].to(device), batch["image"].to(device), cfg.voxel_dim_train)
        reprs[device.type] = type(r)(*(t.cpu() for t in r))
    valid_equal = float((reprs["cuda"].valid == reprs["cpu"].valid).float().mean())
    volume_share = _share_within(reprs["cuda"].volume, reprs["cpu"].volume, 1e-4)
    assert valid_equal >= 0.9999 and volume_share >= 0.999, (valid_equal, volume_share)
    refined = {}
    for device in (cuda, cpu):
        with torch.no_grad():
            out, losses = _model(cfg, state, device, torch.float32).refine(
                type(reprs["cpu"])(*(t.to(device) for t in reprs["cpu"])), _targets(batch, device))
        refined[device.type] = ({k: v.cpu() for k, v in out.items()},
                                {k: float(v) for k, v in losses.items()})
    for k, ref in refined["cpu"][0].items():
        share = _share_within(refined["cuda"][0][k], ref, 1e-4)
        assert share >= 0.9999, (k, share, float((refined["cuda"][0][k] - ref).abs().max()))
    for k, v in refined["cpu"][1].items():
        assert refined["cuda"][1][k] == pytest.approx(v, rel=1e-5), k


@pytest.mark.cuda
def test_bf16_forward_on_the_card_near_the_cpu(cuda):
    cfg, state, batch = _model_and_batch()
    card, _ = _forward(cfg, state, batch, cuda, torch.bfloat16)
    cpu16, _ = _forward(cfg, state, batch, torch.device("cpu"), torch.bfloat16)
    cpu32, _ = _forward(cfg, state, batch, torch.device("cpu"), torch.float32)
    for k in cpu32:
        gap = float((cpu16[k] - cpu32[k]).abs().mean())
        assert float((card[k] - cpu32[k]).abs().mean()) <= 1.5 * gap, k
    assert np.isfinite([float(v.abs().max()) for v in card.values()]).all()
