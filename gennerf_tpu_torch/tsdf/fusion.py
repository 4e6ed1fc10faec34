"""The fusion prior of inference (counterpart of gennerf_tpu/tsdf/fusion.py
`_prior_classes` / `apply_fusion_prior`)."""
from __future__ import annotations

import torch

from ..ops.projection import project_voxels


@torch.no_grad()
def prior_classes(voxel_dim, voxel_size: float, origin, trunc_margin: float,
                  projections: torch.Tensor, depths: torch.Tensor):
    """(near_any, farfront_any) (V,) bools over the T frames.

    near: some frame observes the voxel inside the truncation band
    (|pz - d| < trunc_margin). farfront: some frame observes it more than
    trunc_margin in front of the measured surface (pz - d <= -trunc_margin)."""
    H, W = depths.shape[-2:]
    V = int(voxel_dim[0]) * int(voxel_dim[1]) * int(voxel_dim[2])
    near = torch.zeros(V, dtype=torch.bool, device=depths.device)
    farfront = torch.zeros_like(near)
    for projection, depth in zip(projections, depths):
        px, py, pz, in_view = project_voxels(voxel_dim, voxel_size, origin, projection[None], H, W)
        px, py, pz, in_view = px[0], py[0], pz[0], in_view[0]
        d = depth[py, px]
        valid = in_view & (d > 0)
        near |= valid & (torch.abs(pz - d) < trunc_margin)
        farfront |= valid & ((pz - d) <= -trunc_margin)
    return near, farfront


@torch.no_grad()
def apply_fusion_prior(tsdf_vol: torch.Tensor, voxel_size: float, origin,
                       projections: torch.Tensor, depths: torch.Tensor,
                       trunc_ratio: float = 3.0) -> torch.Tensor:
    """Keep the predicted TSDF in the near-surface band of the (T, 3, 4)
    projections and (T, H, W) depths; elsewhere set the value TSDF fusion
    of those frames gives deterministically: -1 where some frame sees the
    voxel more than the truncation in front of its surface, else +1."""
    voxel_dim = tuple(int(s) for s in tsdf_vol.shape)
    near, farfront = prior_classes(voxel_dim, float(voxel_size), origin,
                                   float(voxel_size) * trunc_ratio, projections, depths)
    flat = tsdf_vol.reshape(-1)
    one = torch.ones((), dtype=flat.dtype, device=flat.device)
    return torch.where(near, flat, torch.where(farfront, -one, one)).reshape(voxel_dim)
