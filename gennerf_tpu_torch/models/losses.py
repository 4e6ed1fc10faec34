"""GenNerf loss terms (counterpart of gennerf_tpu/models/losses.py).

Per-element loss matrices plus the aggregated dict; all loss math runs in
float32 (a bf16 model's outputs are cast first). The distillation term
has its own sample set (one point a ray): its masked mean is added to the
combined loss outside the point-wise masked mean.

Every mean is global in a data-parallel step (`parallel.distributed.
sharded`): the sums of the numerator and of the count over all ranks, as
the JAX package's one global program computes them, so that ranks holding
different valid counts give the whole batch's masked mean (an average of
per-rank means would not); one process computes the expressions as before.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..ops.value_transforms import log_transform, smooth_log_transform
from ..parallel.distributed import global_mean, global_ratio
from .config import LossConfig


def _safe_norm(x: torch.Tensor, dim: int = -1, keepdim: bool = False) -> torch.Tensor:
    """L2 norm whose gradient at a zero vector is 0, not NaN."""
    sq = torch.sum(x * x, dim=dim, keepdim=keepdim)
    safe = torch.where(sq > 0, sq, torch.ones_like(sq))
    return torch.where(sq > 0, torch.sqrt(safe), torch.zeros_like(sq))


def loss_tsdf(cfg: LossConfig, outputs, targets) -> torch.Tensor:
    """L1 on the (optionally log-rescaled) TSDF."""
    pred, trgt = outputs["tsdf"], targets["tsdf"]
    t = cfg.tsdf
    if t.transform == "log":
        pred, trgt = log_transform(pred, t.shift), log_transform(trgt, t.shift)
    elif t.transform == "smooth_log":
        pred = smooth_log_transform(pred, t.shift, t.smoothness)
        trgt = smooth_log_transform(trgt, t.shift, t.smoothness)
    elif t.transform != "none":
        raise NotImplementedError(f"tsdf transform {t.transform}")
    return torch.abs(pred - trgt)


def loss_isdf(cfg: LossConfig, outputs, targets) -> torch.Tensor:
    """iSDF free-space/near-surface loss. On fused-TSDF targets (<= 1
    everywhere) it is trunc_weight * L1, as the reference's."""
    pred, trgt = outputs["tsdf"], targets["tsdf"]
    c = cfg.isdf
    term1 = torch.exp(-c.free_space_factor * pred) - 1.0
    loss_free = torch.maximum(torch.relu(term1), pred - trgt)
    loss_near = torch.abs(pred - trgt) * c.trunc_weight
    mask = (trgt <= 1.0).to(pred.dtype)
    return mask * loss_near + (1 - mask) * loss_free


def loss_eikonal(cfg: LossConfig, outputs, targets) -> torch.Tensor:
    """|‖d tsdf / d xyz‖ - 1|, zeroed where the fused target is below
    eikonal.apply_distance (the reference's gate: the term acts at and
    behind the surface ramp, the clamped +1 region included)."""
    loss = torch.abs(_safe_norm(outputs["grad"], dim=-1) - 1.0)[..., None]
    return torch.where(targets["tsdf"] < cfg.eikonal.apply_distance,
                       torch.zeros((), dtype=loss.dtype, device=loss.device), loss)


def _cos(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    num = (a * b).sum(-1)
    return num / torch.clamp(_safe_norm(a, dim=-1) * _safe_norm(b, dim=-1), min=1e-6)


def loss_gradient(cfg: LossConfig, outputs, targets, num_rays: int) -> torch.Tensor:
    """Cosine distance of the TSDF gradients to the surface normal at each
    ray's surface sample and to the ray-bound gradient (`grad_vec`, the
    sampled normal where that is NaN) at its other samples -> (B, R*S, 1)."""
    normals = targets["sampled_normals"]  # (B, R, 3)
    grad_vec = targets["grad_vec"]  # (B, R, S-1, 3)
    B = normals.shape[0]
    grad = outputs["grad"].reshape(B, num_rays, -1, 3)
    surf_loss = 1.0 - _cos(normals, grad[:, :, 0])
    grad_vec = torch.where(torch.isnan(grad_vec[..., :1]), normals[:, :, None], grad_vec)
    grad_loss = 1.0 - _cos(grad_vec, grad[:, :, 1:])
    return torch.cat([surf_loss[:, :, None], grad_loss], dim=2).reshape(B, -1, 1)


def loss_feat(cfg: LossConfig, outputs, targets) -> torch.Tensor:
    """Encourage non-degenerate encoder features: 1 / mean feature norm."""
    contribution = global_mean(_safe_norm(outputs["feat"], dim=-1))
    return 1.0 / torch.clamp(contribution, min=1e-12)


def loss_distill(cfg: LossConfig, outputs, targets) -> torch.Tensor:
    """Distance of feat_sem_surface (B, R, C) to teacher_feat (B, R, C):
    1 - cosine (its denominator clamped at 1e-6) or the mean squared
    difference, times teacher_mask (B, R, 1) when given -> (B, R, 1)."""
    pred, trgt = outputs["feat_sem_surface"], targets["teacher_feat"]
    if cfg.distill.metric == "cosine":
        num = (pred * trgt).sum(-1, keepdim=True)
        den = torch.clamp(_safe_norm(pred, keepdim=True) * _safe_norm(trgt, keepdim=True),
                          min=1e-6)
        loss = 1.0 - num / den
    elif cfg.distill.metric == "l2":
        loss = ((pred - trgt) ** 2).mean(-1, keepdim=True)
    else:
        raise NotImplementedError(f"distill metric {cfg.distill.metric!r}")
    mask = targets.get("teacher_mask")
    return loss if mask is None else loss * mask


def _masked_mean(m: torch.Tensor, valid: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean over valid samples only; `valid` is (B, N, 1) in {0, 1} or None."""
    if valid is None:
        return global_mean(m)
    w = torch.broadcast_to(valid, m.shape)
    return global_ratio((m * w).sum(), w.sum())


def calculate_loss(cfg: LossConfig, outputs: Dict[str, torch.Tensor],
                   targets: Dict[str, torch.Tensor], num_rays: int = 0
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Weighted sum of the enabled terms. With targets['valid'] ((B, N, 1)
    float) every point-wise term averages over valid samples only. The
    eikonal and gradient terms read outputs['grad']; the gradient term also
    targets['sampled_normals'] and ['grad_vec'] of `num_rays` rays. The
    distillation term, when targets['teacher_feat'] is given, averages over
    teacher_mask's support ('distill', and 'distill_coverage' the mask's
    mean).

    Returns (combined loss, dict of per-term means incl. 'combined' and,
    with a mask, 'valid_coverage')."""
    if not (cfg.use_tsdf or cfg.use_isdf):
        raise ValueError("the loss needs use_tsdf or use_isdf")
    outputs = {k: v.to(torch.float32) for k, v in outputs.items()}
    targets = {k: v.to(torch.float32) if v.is_floating_point() else v for k, v in targets.items()}
    valid = targets.get("valid")
    losses: Dict[str, torch.Tensor] = {}
    loss_mat = 0.0
    loss_scalar = 0.0
    if cfg.use_tsdf:
        m = loss_tsdf(cfg, outputs, targets)
        losses["tsdf"] = _masked_mean(m, valid)
        loss_mat = loss_mat + cfg.tsdf.weight * m
    if cfg.use_isdf:
        m = loss_isdf(cfg, outputs, targets)
        losses["isdf"] = _masked_mean(m, valid)
        loss_mat = loss_mat + cfg.isdf.weight * m
    if cfg.use_eikonal:
        m = loss_eikonal(cfg, outputs, targets)
        losses["eikonal"] = _masked_mean(m, valid)
        loss_mat = loss_mat + cfg.eikonal.weight * m
    if cfg.use_gradient:
        m = loss_gradient(cfg, outputs, targets, num_rays)
        losses["gradient"] = _masked_mean(m, valid)
        loss_mat = loss_mat + cfg.gradient.weight * m
    if cfg.use_feature:
        m = loss_feat(cfg, outputs, targets)
        losses["feature"] = m
        loss_scalar = loss_scalar + cfg.feature.weight * m
    if cfg.use_distill and "teacher_feat" in targets:
        m = loss_distill(cfg, outputs, targets)
        tm = targets.get("teacher_mask")
        d = global_mean(m) if tm is None else _masked_mean(m, tm)
        losses["distill"] = d
        if tm is not None:
            losses["distill_coverage"] = global_mean(tm)
        loss_scalar = loss_scalar + cfg.distill.weight * d
    combined = _masked_mean(loss_mat, valid) + loss_scalar
    if valid is not None:
        losses["valid_coverage"] = global_mean(valid)
    losses["combined"] = combined
    return combined, losses
