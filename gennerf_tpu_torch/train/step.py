"""The train and eval steps of both model families (counterpart of
gennerf_tpu/train/step.py; GenNerf with ray- or frustum-mode supervision,
the gradient losses and semantic distillation).

A step encodes the batch's frames (presample and FPS: the FPS kernel on the
card), samples supervision points on every frame (ray mode: rays through
valid depth pixels, with the gradient loss through pixels of finite
normals too; frustum mode: surface, near-surface and free-space points),
decodes them through the per-point path (`GenNerf.decode`, or
`decode_with_grad` when the eikonal or gradient loss is on: the point
kernel has no backward), interpolates their targets from the fused
ground-truth volume and computes the loss. As in the reference, the T
frames are sampled and decoded at once and the loss is the per-frame mean
summed over frames, i.e. the mean times T.

With the spatial encoder (or use_auxiliary) the step also backprojects
every frame's 2D features into the feature volume (models/gen_nerf.py).

With loss.use_distill and a teacher, feat_sem is distilled toward the
teacher's features of the frames (models/teacher.py). Surface mode (ray
sampling only) supervises each ray's surface sample at its pixel, masked
by the pixel's validity. Render mode draws render_rays valid-depth pixels
a frame, marches their rays through the current field (`GenNerf.decode`
under no_grad, clipped to the volume's box: the reference's forward-only
march, its depths stop-gradient) and decodes feat_sem at the first
crossings (with gt_warmstart, at the ground-truth depth's point where a
ray has none), masked by the pixel's validity (and, without gt_warmstart,
the crossing); `render_hit_rate` is the share of rays that crossed. As in
the reference, use_distill adds nothing without a teacher (teacher.type
'none') or in surface mode under frustum sampling.

The random draws come from one torch.Generator in a fixed order (presample,
FPS start, pixel scores, then the ray noise, or the frustum depths and the
near-surface noise, then the render mode's pixel scores), or are injected
(`StepDraws`): tests pass the draws of the reference's key splits.

A VoxelNet step encodes the frames into the feature volume at origin 0,
refines it into the multi-scale TSDF volumes and sums the per-scale losses
against the batch's ground truth at each scale (vol_08_tsdf, vol_04_tsdf,
...). It draws only the 3D backbone's dropout masks (backbone3d.drop > 0,
in training), from the step's generator or injected (`StepDraws.dropout`,
in the JAX module's call order). Its metrics are each `vol_XX_tsdf_loss`
and their sum `tsdf_loss`, the loss.

Under bf16-mixed the render mode's march reads the model's bf16 TSDF, as
the JAX march does; its depths and points are float32.

Data parallel (`sharded=True`, one rank of a process group holding its
rows of the global batch; parallel/): every rank holds the same generator
state and draws the global batch's rows, keeping its own (ops/sampling.py),
and injected draws are global too (each rank takes its rows), so the
stream is the one-process run's; the losses, metrics and BatchNorm
statistics are global (parallel.distributed.global_sum), and
`train_step` sums the gradients over the ranks after backward, before the
optimizer (and its clip). The result is the one-process step's on the
global batch, up to summation order.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import set_reference_precision
from ..models.config import GenNerfConfig
from ..models.backbone3d import DropoutDraws
from ..models.gen_nerf import GenNerf
from ..models.voxel_net import VoxelNet
from ..models.losses import calculate_loss
from ..models.renderer import pixels_to_rays, ray_march_tsdf
from ..models.teacher import sample_teacher_features
from ..ops.interpolation import trilinear_interpolation
from ..ops.normals import estimate_pointcloud_normals
from ..ops.projection import get_3d_points
from ..parallel import distributed
from ..ops.sampling import (
    bounds_pc_batch, draw_normal, sample_points_in_frustum, sample_points_on_rays,
    sample_valid_depth_pixels, sample_valid_pixels,
)
from ..utils.spans import span


class StepDraws(NamedTuple):
    """One step's random draws; None draws from the step's generator."""

    sel: Optional[torch.Tensor] = None     # (B*T, presample) presample indices
    start: Optional[torch.Tensor] = None   # (B*T,) FPS start indices
    scores: Optional[torch.Tensor] = None  # (B*T, H*W) uniform pixel scores (either mode)
    noise: Optional[torch.Tensor] = None   # (B*T, num_rays, M) standard normal
    frustum_u: Optional[torch.Tensor] = None   # (B*T, N_free) uniform frustum depths
    near_noise: Optional[torch.Tensor] = None  # (B*T, N_near, 3) standard normal
    render_scores: Optional[torch.Tensor] = None  # (B*T, H*W) uniform, render distillation
    # VoxelNet: the 3D backbone's dropout keep masks (bool, channels-first), in call order
    dropout: Optional[Sequence[torch.Tensor]] = None


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
                              draws: StepDraws = StepDraws()) -> Dict:
    """Supervision points of every frame, in the config's sampling mode.

    Returns xyz (B*T, P, 3) world points and valid (B*T, P, 1) float,
    P = points_per_frame. Ray mode: P = R*S, S = 1 + N + M samples a ray,
    each inheriting its pixel's validity (rays backfilled from invalid
    pixels drop out of the loss); with loss.use_gradient the pixels also
    need a finite normal, and sampled_normals (B*T, R, 3) and grad_vec
    (B*T, R, S-1, 3) (the negated bound gradients) come along; so do the
    rays' pixels h, w (B*T, R) and their validity valid_pix. Frustum
    mode: P = N_surf + N_near + N_free, the surface and near points valid
    where their pixel's depth is, the free points always."""
    depth = batch["depth"]
    B, T, H, W = depth.shape
    BT = B * T
    depth_bt = depth.reshape(BT, H, W)
    intr_bt = batch["intrinsics"].reshape(BT, 3, 3)
    pose_bt = batch["pose"].reshape(BT, 4, 4)
    if cfg.sampling_mode == "frustum":
        f = cfg.frustum
        n_near = f.N_free + f.N_near
        b, h, w, ok = sample_valid_depth_pixels(depth_bt, n_near + f.N_surf, generator,
                                                draws.scores)
        free_xyz, _ = sample_points_in_frustum(h[:, :f.N_free], w[:, :f.N_free], intr_bt, pose_bt,
                                               f.d_min, f.d_max, generator, draws.frustum_u)
        surface = get_3d_points(depth_bt, batch["projection"].reshape(BT, 3, 4))
        surf_xyz = surface[b, h[:, n_near:], w[:, n_near:]]
        near_xyz = surface[b, h[:, f.N_free:n_near], w[:, f.N_free:n_near]]
        noise = draws.near_noise
        if noise is None:
            noise = draw_normal(near_xyz.shape, generator, near_xyz.device)
        near_xyz = near_xyz + f.sigma * noise.to(near_xyz.device, near_xyz.dtype)
        valid = torch.cat([ok[:, n_near:], ok[:, f.N_free:n_near],
                           torch.ones_like(ok[:, :f.N_free])], dim=1)
        return {"xyz": torch.cat([surf_xyz, near_xyz, free_xyz], dim=1),
                "valid": valid[..., None].to(torch.float32), "points_per_frame": n_near + f.N_surf}
    if cfg.sampling_mode != "ray":
        raise NotImplementedError(f"sampling_mode {cfg.sampling_mode!r} is not ported")
    ray = cfg.ray
    R, S = ray.num_rays, 1 + ray.N + ray.M
    out = {}
    if cfg.loss.use_gradient:
        normals = estimate_pointcloud_normals(
            get_3d_points(depth_bt, batch["projection"].reshape(BT, 3, 4)))
        b, h, w, ok = sample_valid_pixels(depth_bt, normals, R, generator, draws.scores)
        out["sampled_normals"] = normals[b, h, w]
    else:
        b, h, w, ok = sample_valid_depth_pixels(depth_bt, R, generator, draws.scores)
    sampled_depth = depth_bt[b, h, w]
    xyz, z = sample_points_on_rays(
        h, w, sampled_depth, intr_bt, pose_bt, N=ray.N, M=ray.M, delta=ray.delta,
        min_dist=ray.d_min, sigma=ray.sigma, generator=generator, noise=draws.noise)
    if cfg.loss.use_gradient:
        out["grad_vec"] = -bounds_pc_batch(xyz, z, sampled_depth)[1]
    valid = ok[:, :, None].expand(BT, R, S).reshape(BT, R * S, 1).to(torch.float32)
    return {**out, "xyz": xyz.reshape(BT, R * S, 3), "valid": valid, "points_per_frame": R * S,
            "h": h, "w": w, "valid_pix": ok}


def render_distill_points(model: GenNerf, batch: Dict[str, torch.Tensor], repr_, origin,
                          voxel_dim, generator: Optional[torch.Generator] = None,
                          scores: Optional[torch.Tensor] = None):
    """Render mode's supervision: render_rays valid-depth pixels a frame,
    their rays marched through the current field without gradients (the
    first crossing inside the volume's box at `origin`), and each ray's
    point: the crossing, or under gt_warmstart the ground-truth depth's
    point where the ray has none. Returns (points (B, T*Rr, 3), h, w, mask,
    hit), the last four (B*T, Rr); mask is the pixel's validity (and the
    crossing without gt_warmstart)."""
    cfg, dcfg = model.cfg, model.cfg.loss.distill
    B, T, H, W = batch["depth"].shape
    BT, Rr = B * T, dcfg.render_rays
    depth_bt = batch["depth"].reshape(BT, H, W)
    _, h, w, ok = sample_valid_depth_pixels(depth_bt, Rr, generator, scores)
    origins, dirs = pixels_to_rays(h.to(torch.float32), w.to(torch.float32),
                                   batch["intrinsics"].reshape(BT, 3, 3),
                                   batch["pose"].reshape(BT, 4, 4))
    origins, dirs = origins.reshape(B, T * Rr, 3), dirs.reshape(B, T * Rr, 3)
    box = torch.tensor(tuple(voxel_dim), dtype=torch.float32, device=origin.device)
    with torch.no_grad():
        volume_cl = model.volume_features(repr_)
        depth_r, hit = ray_march_tsdf(
            lambda p: model.decode(repr_, p, origin, volume_cl)["tsdf"][..., 0], origins, dirs,
            near=dcfg.render_near, far=dcfg.render_far, n_steps=dcfg.render_steps,
            n_secant_steps=dcfg.render_secant, n_fine_steps=dcfg.render_fine,
            convention="fusion", aabb=(origin, origin + box * cfg.voxel_size))
    points = origins + dirs * depth_r[..., None]
    hit_bt = hit.reshape(BT, Rr)
    if dcfg.gt_warmstart:
        surface = get_3d_points(depth_bt, batch["projection"].reshape(BT, 3, 4))
        bidx = torch.arange(BT, device=h.device)[:, None]
        points = torch.where(hit[..., None], points, surface[bidx, h, w].reshape(B, T * Rr, 3))
        mask = ok
    else:
        mask = ok & hit_bt
    return points, h, w, mask, hit_bt


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
    masked mean times T, except the *_coverage and *_rate fractions; the
    loss is metrics['combined']."""
    cfg = model.cfg
    B, T = batch["image"].shape[:2]
    origin = batch.get("origin_zero")
    if origin is None:
        origin = torch.zeros(3, dtype=torch.float32, device=batch["image"].device)
    voxel_dim = voxel_dim or cfg.voxel_dim_train
    repr_ = model.encode(batch["projection"], batch["image"], batch["depth"], generator,
                         draws.sel, draws.start, voxel_dim, origin)
    sup = sample_supervision_points(cfg, batch, generator, draws)
    BT, S = B * T, sup["points_per_frame"]
    xyz = sup["xyz"].reshape(B, T * S, 3)
    if cfg.loss.use_eikonal or cfg.loss.use_gradient:
        outputs = model.decode_with_grad(repr_, xyz, origin)
    else:
        outputs = model.decode(repr_, xyz, origin)
    tsdf_vol = batch["vol_%02d_tsdf" % int(cfg.voxel_size * 100)]  # (B, 1, nx, ny, nz)
    target = trilinear_interpolation(tsdf_vol.permute(0, 2, 3, 4, 1), xyz, origin,
                                     cfg.voxel_size)
    outputs_bt = {k: v.reshape(BT, S, -1) for k, v in outputs.items()}
    targets_bt = {"tsdf": target.reshape(BT, S, 1), "valid": sup["valid"]}
    if cfg.loss.use_gradient:
        targets_bt["sampled_normals"] = sup["sampled_normals"]
        targets_bt["grad_vec"] = sup["grad_vec"]
    extra = {}
    mode = cfg.loss.distill.mode
    if cfg.loss.use_distill and model.teacher is not None and (
            mode == "render" or (mode == "surface" and cfg.sampling_mode == "ray")):
        H, W = batch["image"].shape[-2:]
        if mode == "surface":
            h, w, mask = sup["h"], sup["w"], sup["valid_pix"]
            feat_sem = outputs["feat_sem"].reshape(BT, cfg.ray.num_rays, -1,
                                                   cfg.mlp.d_out_sem)[:, :, 0]
        else:
            points, h, w, mask, hit = render_distill_points(
                model, batch, repr_, origin, voxel_dim, generator, draws.render_scores)
            feat_sem = model.decode(repr_, points, origin)["feat_sem"].reshape(BT, h.shape[1], -1)
            extra["render_hit_rate"] = distributed.global_mean(hit.to(torch.float32))
        tmap = model.teacher(batch["image"].reshape(BT, 3, H, W))
        outputs_bt["feat_sem_surface"] = feat_sem
        targets_bt["teacher_feat"] = sample_teacher_features(tmap, h, w, (H, W))
        targets_bt["teacher_mask"] = mask[..., None].to(torch.float32)
    _, losses = calculate_loss(cfg.loss, outputs_bt, targets_bt, num_rays=cfg.ray.num_rays)
    metrics = {k: v if k.endswith(("_coverage", "_rate")) else v * T for k, v in losses.items()}
    return metrics["combined"], {**metrics, **extra}


def voxel_net_forward_loss(model: VoxelNet, batch: Dict[str, torch.Tensor], voxel_dim=None,
                           generator: Optional[torch.Generator] = None,
                           draws: StepDraws = StepDraws()
                           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Encode at `voxel_dim` (default voxel_dim_train) and origin 0, refine
    (in training mode with backbone3d.drop > 0 the dropout masks are
    `draws.dropout`, else drawn from `generator`), and the per-scale
    losses against the batch's ground truth volumes (every scale's key
    must be present). Returns (the summed loss, metrics): each
    vol_XX_tsdf_loss and tsdf_loss."""
    cfg = model.cfg
    origin = torch.zeros(3, dtype=torch.float32, device=batch["image"].device)
    targets = {k: batch[k] for k in ("vol_%02d_tsdf" % vs for vs in model.cfg.voxel_sizes)}
    dropout = DropoutDraws(cfg.backbone3d.drop, draws.dropout, generator)
    _, losses = model(batch["projection"], batch["image"], voxel_dim or cfg.voxel_dim_train,
                      origin, targets, dropout)
    loss = sum(losses.values())
    return loss, {**losses, "tsdf_loss": loss}


def forward_loss(model, batch: Dict[str, torch.Tensor], generator=None,
                 draws: StepDraws = StepDraws(), voxel_dim=None):
    """The family's forward and loss: (loss, metrics)."""
    if isinstance(model, VoxelNet):
        return voxel_net_forward_loss(model, batch, voxel_dim, generator, draws)
    return gen_nerf_forward_loss(model, batch, generator, draws, voxel_dim)


def rank_draws(draws: StepDraws) -> StepDraws:
    """This rank's rows of injected global-batch draws in a data-parallel
    step (axis 0 of every tensor, in lists and tuples too); unchanged
    outside one."""
    n = distributed.shard_count()
    if n == 1:
        return draws
    i = distributed.shard_index()

    def rows(x):
        if x is None:
            return None
        if isinstance(x, (list, tuple)):
            return type(x)(rows(v) for v in x)
        return x[distributed.local_batch_slice(x.shape[0], n, i)]

    return StepDraws(*(rows(v) for v in draws))


def train_step(model, optimizer: torch.optim.Optimizer, batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None,
               draws: StepDraws = StepDraws(), sharded: bool = False) -> Dict[str, torch.Tensor]:
    """Forward (the feature volume at voxel_dim_train), backward and one
    optimizer step of a GenNerf or a VoxelNet; in training mode the
    spatial encoder's (and the 3D backbone's) running BatchNorm statistics
    move once per step (per frame chunk for the encoder). With `sharded`,
    `batch` is this rank's rows of the global batch (module docstring).
    Returns the detached metrics (device tensors: reading them waits for
    the step)."""
    set_reference_precision()
    with span("gennerf.step"):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        with distributed.sharded(sharded):
            with span("gennerf.forward"):
                loss, metrics = forward_loss(model, batch, generator, rank_draws(draws))
            with span("gennerf.backward"):
                loss.backward()
            with span("gennerf.allreduce"):
                distributed.all_reduce_gradients(model.parameters())
        with span("gennerf.optimizer"):
            optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}


@torch.no_grad()
def eval_step(model, batch: Dict[str, torch.Tensor],
              generator: Optional[torch.Generator] = None,
              draws: StepDraws = StepDraws(), sharded: bool = False) -> Dict[str, torch.Tensor]:
    """The forward and loss of a step without gradients (the feature
    volume at voxel_dim_val, BatchNorm on its running statistics); returns
    the metrics (global with `sharded`)."""
    set_reference_precision()
    model.eval()
    with distributed.sharded(sharded):
        return forward_loss(model, batch, generator, rank_draws(draws),
                            model.cfg.voxel_dim_val)[1]
