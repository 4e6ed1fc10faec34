"""The GenNerf train and eval steps (counterpart of gennerf_tpu/train/step.py,
ray-mode supervision without distillation).

A step encodes the batch's frames (presample and FPS: the FPS kernel on the
card), samples supervision rays on every frame's valid depth pixels, decodes
the ray points through the f32 per-point path (`GenNerf.decode`: the point
kernel has no backward), interpolates their targets from the fused
ground-truth volume and computes the loss. As in the reference, the T
frames are sampled and decoded at once and the loss is the per-frame mean
summed over frames, i.e. the mean times T.

With the spatial encoder the step also backprojects every frame's ResNet
features into the feature volume (models/gen_nerf.py).

The random draws come from one torch.Generator in a fixed order (presample,
FPS start, pixel scores, ray noise), or are injected (`StepDraws`): tests
pass the draws of the reference's key splits.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import set_reference_precision
from ..models.config import GenNerfConfig
from ..models.gen_nerf import GenNerf
from ..models.losses import calculate_loss
from ..ops.interpolation import trilinear_interpolation
from ..ops.sampling import sample_points_on_rays, sample_valid_depth_pixels


class StepDraws(NamedTuple):
    """One step's random draws; None draws from the step's generator."""

    sel: Optional[torch.Tensor] = None     # (B*T, presample) presample indices
    start: Optional[torch.Tensor] = None   # (B*T,) FPS start indices
    scores: Optional[torch.Tensor] = None  # (B*T, H*W) uniform pixel scores
    noise: Optional[torch.Tensor] = None   # (B*T, num_rays, M) standard normal


def batch_to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """The numeric arrays (or tensors) of a batch as float32 tensors on
    `device`; the loaders' lists (scene names, file names) stay behind. To
    a CUDA device host arrays go through pinned memory and copy without
    blocking the host."""
    to_cuda = torch.device(device).type == "cuda"
    out = {}
    for k, v in batch.items():
        if isinstance(v, torch.Tensor) or (isinstance(v, np.ndarray) and v.dtype.kind in "biuf"):
            t = torch.as_tensor(v, dtype=torch.float32)
            if to_cuda and t.device.type == "cpu":
                t = t.pin_memory()
            out[k] = t.to(device, non_blocking=to_cuda)
    return out


def sample_supervision_points(cfg: GenNerfConfig, batch: Dict[str, torch.Tensor],
                              generator: Optional[torch.Generator] = None,
                              scores: Optional[torch.Tensor] = None,
                              noise: Optional[torch.Tensor] = None) -> Dict:
    """Ray-mode supervision points of every frame.

    Returns xyz (B*T, R*S, 3) world points, S = 1 + N + M per ray, valid
    (B*T, R*S, 1) float (each sample inherits its pixel's validity, so rays
    backfilled from invalid pixels drop out of the loss) and
    points_per_frame R*S."""
    if cfg.sampling_mode != "ray":
        raise NotImplementedError(f"sampling_mode {cfg.sampling_mode!r} is not ported")
    depth = batch["depth"]
    B, T, H, W = depth.shape
    BT = B * T
    ray = cfg.ray
    R, S = ray.num_rays, 1 + ray.N + ray.M
    depth_bt = depth.reshape(BT, H, W)
    b, h, w, ok = sample_valid_depth_pixels(depth_bt, R, generator, scores)
    xyz, _ = sample_points_on_rays(
        h, w, depth_bt[b, h, w], batch["intrinsics"].reshape(BT, 3, 3),
        batch["pose"].reshape(BT, 4, 4), N=ray.N, M=ray.M, delta=ray.delta,
        min_dist=ray.d_min, sigma=ray.sigma, generator=generator, noise=noise)
    valid = ok[:, :, None].expand(BT, R, S).reshape(BT, R * S, 1).to(torch.float32)
    return {"xyz": xyz.reshape(BT, R * S, 3), "valid": valid, "points_per_frame": R * S}


def gen_nerf_forward_loss(model: GenNerf, batch: Dict[str, torch.Tensor],
                          generator: Optional[torch.Generator] = None,
                          draws: StepDraws = StepDraws(), voxel_dim=None
                          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Encode (the feature volume, if any, at `voxel_dim`, default the
    config's voxel_dim_train), sample supervision, decode, loss; the volume
    and the targets from the batch's ground truth share the origin
    `origin_zero` (world position of voxel 0; the unaugmented crop's 0
    when the batch has none).

    Returns (the loss to backpropagate, metrics): every metric is the
    masked mean times T, except the *_coverage fractions; the loss is
    metrics['combined']."""
    cfg = model.cfg
    B, T = batch["image"].shape[:2]
    origin = batch.get("origin_zero")
    if origin is None:
        origin = torch.zeros(3, dtype=torch.float32, device=batch["image"].device)
    repr_ = model.encode(batch["projection"], batch["image"], batch["depth"], generator,
                         draws.sel, draws.start, voxel_dim or cfg.voxel_dim_train, origin)
    sup = sample_supervision_points(cfg, batch, generator, draws.scores, draws.noise)
    BT, S = B * T, sup["points_per_frame"]
    xyz = sup["xyz"].reshape(B, T * S, 3)
    outputs = model.decode(repr_, xyz, origin)
    tsdf_vol = batch["vol_%02d_tsdf" % int(cfg.voxel_size * 100)]  # (B, 1, nx, ny, nz)
    target = trilinear_interpolation(tsdf_vol.permute(0, 2, 3, 4, 1), xyz, origin,
                                     cfg.voxel_size)
    outputs_bt = {k: v.reshape(BT, S, -1) for k, v in outputs.items()}
    targets_bt = {"tsdf": target.reshape(BT, S, 1), "valid": sup["valid"]}
    _, losses = calculate_loss(cfg.loss, outputs_bt, targets_bt)
    metrics = {k: v if k.endswith("_coverage") else v * T for k, v in losses.items()}
    return metrics["combined"], metrics


def train_step(model: GenNerf, optimizer: torch.optim.Optimizer, batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None,
               draws: StepDraws = StepDraws()) -> Dict[str, torch.Tensor]:
    """Forward (the feature volume at voxel_dim_train), backward and one
    optimizer step; in training mode the spatial encoder's running
    BatchNorm statistics move once per frame chunk. Returns the detached
    metrics (device tensors: reading them waits for the step)."""
    set_reference_precision()
    model.train()
    optimizer.zero_grad(set_to_none=True)
    loss, metrics = gen_nerf_forward_loss(model, batch, generator, draws)
    loss.backward()
    optimizer.step()
    return {k: v.detach() for k, v in metrics.items()}


@torch.no_grad()
def eval_step(model: GenNerf, batch: Dict[str, torch.Tensor],
              generator: Optional[torch.Generator] = None,
              draws: StepDraws = StepDraws()) -> Dict[str, torch.Tensor]:
    """The forward and loss of a step without gradients (the feature
    volume at voxel_dim_val, BatchNorm on its running statistics); returns
    the metrics."""
    set_reference_precision()
    model.eval()
    return gen_nerf_forward_loss(model, batch, generator, draws, model.cfg.voxel_dim_val)[1]
