"""chip_smoke.ReluPicks on the CPU: the float64-against-float32 gradient
gates record one step's ReLU masks and UNet max-pool picks and replay them
in the other steps of the same weights and inputs.

A tiny pointnet GenNerf with a depth-2 UNet and the eikonal term (2 frames
of 12x16, c_dim 8, 16 rays); every step takes the float32 step's FPS picks
(as the gates do), so that both dtypes encode the same points. Checked:
replaying a step's own picks without pinning is that step bit for bit and
counts no pick made otherwise; pinned to a float64 step's picks the float32
step stays within 1e-5 of its gradients' max-abs of the plain float32 step;
one recorded ReLU pick turned the other way (in the step's last ReLU, so
that no later pick follows from it) is counted once and moves the pinned
step; a step whose calls do not match the recording raises.
"""
import contextlib
import os
import sys
from unittest import mock

import pytest
import torch

from gennerf_tpu_torch.data.synthetic import training_batch
from gennerf_tpu_torch.models.config import GenNerfConfig, config_from_dict
from gennerf_tpu_torch.models import gen_nerf as gen_nerf_module
from gennerf_tpu_torch.models.gen_nerf import GenNerf
from gennerf_tpu_torch.ops.sampling import farthest_point_sample_plain
from gennerf_tpu_torch.train.step import StepDraws, gen_nerf_forward_loss

import _torch_threads  # noqa: F401  (sizes torch's threads per xdist worker)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

T, H, W = 2, 12, 16
VOXEL_DIM = [16, 16, 8]
CFG = {
    "type": "GenNerf", "voxel_size": 0.08, "sampling_mode": "ray",
    "voxel_dim_train": VOXEL_DIM, "voxel_dim_val": VOXEL_DIM, "voxel_dim_test": VOXEL_DIM,
    "encoder": {"use_spatial": False, "use_pointnet": True,
                "pointnet": {"num_sparse_points": 32, "fps_presample": 64,
                             "normalize_coords": True, "c_dim": 8, "hidden_dim": 8,
                             "plane_resolution": 16, "n_blocks": 2, "unet": True,
                             "unet_kwargs": {"depth": 2, "merge_mode": "concat",
                                             "start_filts": 8}}},
    "mlp": {"d_out_sem": 1, "d_out_geo": 8, "n_blocks": 2, "d_hidden": 32, "alpha": 0.7},
    "code": {"num_freqs": 6, "freq_factor": 0.5, "include_input": True},
    "ray": {"num_rays": 16, "N": 5, "M": 3},
    "loss": {"use_tsdf": True, "use_eikonal": True,
             "tsdf": {"weight": 1.0, "transform": "smooth_log", "shift": 15.0,
                      "smoothness": 10.0},
             "eikonal": {"weight": 0.3, "apply_distance": 0.2}},
    "optimizer": {"type": "Adam", "lr": 0.001, "weight_decay": 0.0001},
}


@pytest.fixture(scope="module")
def setup():
    cfg = config_from_dict(GenNerfConfig, CFG)
    batch = {k: torch.from_numpy(v) for k, v in
             training_batch(1, T, H, W, VOXEL_DIM, 0.08, seed=3).items()}
    torch.manual_seed(0)
    state = GenNerf(cfg).state_dict()
    g = torch.Generator().manual_seed(1)
    draws = StepDraws(sel=torch.randint(0, H * W, (T, 64), generator=g),
                      start=torch.randint(0, 64, (T,), generator=g),
                      scores=torch.rand((T, H * W), generator=g),
                      noise=torch.randn((T, 16, 3), generator=g))
    picked = {}

    def fps(xyz, npoint, generator=None, start=None):
        if "idx" not in picked:
            picked["idx"] = farthest_point_sample_plain(xyz, npoint, start)
        idx = picked["idx"]
        return torch.gather(xyz, 1, idx.long()[..., None].expand(-1, -1, 3)), idx

    with mock.patch.object(gen_nerf_module, "farthest_point_sample", fps):
        setup = cfg, batch, state, draws
        _step(setup, torch.float32)
        yield setup


def _step(setup, dtype, picks=None):
    """Loss and gradients of one step in `dtype`; `picks(model)` is a
    context around the forward and backward."""
    cfg, batch, state, draws = setup
    m = GenNerf(cfg).to(dtype).train()
    m.load_state_dict(state)

    def to(v):
        return v.to(dtype) if v.is_floating_point() else v

    d = draws._replace(**{k: to(getattr(draws, k)) for k in draws._fields
                          if getattr(draws, k) is not None})
    with picks(m) if picks is not None else contextlib.nullcontext() as counts:
        loss, _ = gen_nerf_forward_loss(m, {k: to(v) for k, v in batch.items()}, draws=d)
        loss.backward()
    return float(loss.detach()), {n: p.grad.double() for n, p in m.named_parameters()}, counts


def _dist(a, b):
    return max(float((a[n] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
               for n, g in b.items())


def test_own_picks_replayed_unpinned_is_the_plain_step(setup):
    picks = chip_smoke.ReluPicks(torch)
    loss_rec, grads_rec, _ = _step(setup, torch.float32, picks.recording)
    kinds = [p.dtype for p in picks.picks]
    assert torch.bool in kinds and torch.int64 in kinds  # ReLU masks and max-pool argmaxes
    loss, grads, _ = _step(setup, torch.float32)
    loss_rep, grads_rep, counts = _step(
        setup, torch.float32, lambda m: picks.replaying(m, pin=False))
    assert loss_rec == loss == loss_rep
    assert all(torch.equal(grads[n], grads_rec[n]) and torch.equal(grads[n], grads_rep[n])
               for n in grads)
    assert counts == {"relu": 0, "max_pool": 0, "calls": len(picks.picks)}


def test_pinned_to_float64_picks(setup):
    picks = chip_smoke.ReluPicks(torch)
    _, g64, _ = _step(setup, torch.float64, picks.recording)
    _, plain, _ = _step(setup, torch.float32)
    _, pinned, counts = _step(setup, torch.float32, lambda m: picks.replaying(m))
    assert counts["calls"] == len(picks.picks)
    assert _dist(pinned, plain) <= 1e-5
    assert _dist(pinned, g64) <= 1e-4

    # one positive input of the last ReLU recorded as not positive: counted,
    # and the pinned step no longer is the plain one
    last = picks.picks[-1]
    assert last.dtype == torch.bool and last.any()
    flipped = last.clone().reshape(-1)
    flipped[int(flipped.nonzero()[0])] = False
    picks.picks[-1] = flipped.reshape(last.shape)
    _, moved, counts = _step(setup, torch.float32, lambda m: picks.replaying(m))
    assert counts["relu"] == 1 and counts["max_pool"] == 0
    assert _dist(moved, plain) > 1e-5


def test_a_step_that_does_not_match_raises(setup):
    picks = chip_smoke.ReluPicks(torch)
    _step(setup, torch.float32, picks.recording)
    picks.picks.pop()
    with pytest.raises(RuntimeError, match="does not match the recorded step"):
        _step(setup, torch.float32, lambda m: picks.replaying(m))
