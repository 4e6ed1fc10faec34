"""TSDF fusion of posed depth maps and the fusion prior of inference
(counterpart of gennerf_tpu/tsdf/fusion.py: `integrate`, `fuse_frames`,
`TSDFFusion`, `_prior_classes`, `apply_fusion_prior`). Fusion keeps the
TSDF channel only (the color and label channels are not ported).

Fusion semantics, per frame: voxels in the frustum with valid depth and
dist = max((pz - d) / trunc_margin, -1) < 1 are valid; a first touch
(weight 0) copies dist, later touches accumulate it only in the
near-surface band (dist > -1), whose touches the weight counts; the fused
TSDF divides the sum by the weight.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.projection import project_voxels


class FusionState(NamedTuple):
    """Dense fusion accumulators, flat over V = nx*ny*nz voxels."""

    tsdf: torch.Tensor    # (V,) accumulated truncated distances
    weight: torch.Tensor  # (V,) near-surface observation count


def init_state(voxel_dim, device=None) -> FusionState:
    V = int(voxel_dim[0]) * int(voxel_dim[1]) * int(voxel_dim[2])
    return FusionState(torch.ones(V, dtype=torch.float32, device=device),
                       torch.zeros(V, dtype=torch.float32, device=device))


@torch.no_grad()
def integrate(state: FusionState, voxel_dim, voxel_size: float, origin, trunc_margin: float,
              projection: torch.Tensor, depth: torch.Tensor) -> FusionState:
    """Accumulate one (H, W) depth frame (0 = invalid) seen through a
    (3, 4) world->image projection."""
    H, W = depth.shape
    px, py, pz, in_view = project_voxels(voxel_dim, voxel_size, origin, projection[None], H, W)
    px, py, pz, in_view = px[0], py[0], pz[0], in_view[0]
    d = depth[py, px]
    dist = torch.clamp((pz - d) / trunc_margin, min=-1.0)
    valid = in_view & (d > 0) & (dist < 1)
    first_touch = state.weight == 0
    tsdf = torch.where(valid & first_touch, dist, state.tsdf)
    near = valid & (dist > -1)
    tsdf = torch.where(near & ~first_touch, tsdf + dist, tsdf)
    return FusionState(tsdf, state.weight + near.to(state.weight.dtype))


@torch.no_grad()
def fuse_frames(voxel_dim, voxel_size: float, origin, trunc_margin: float,
                projections: torch.Tensor, depths: torch.Tensor) -> FusionState:
    """Fuse (T, 3, 4) projections and (T, H, W) depths frame by frame."""
    state = init_state(voxel_dim, depths.device)
    for projection, depth in zip(projections, depths):
        state = integrate(state, voxel_dim, voxel_size, origin, trunc_margin, projection, depth)
    return state


class TSDFFusion:
    """Stateful wrapper carrying the accumulators between `integrate` calls."""

    def __init__(self, voxel_dim=(128, 128, 128), voxel_size: float = 0.02,
                 origin=(0.0, 0.0, 0.0), trunc_ratio: float = 3, device=None):
        self.voxel_dim = tuple(int(d) for d in voxel_dim)
        self.voxel_size = float(voxel_size)
        self.origin = torch.as_tensor(origin, dtype=torch.float32, device=device).reshape(3)
        self.trunc_margin = self.voxel_size * trunc_ratio
        self.state = init_state(self.voxel_dim, device)

    def integrate(self, projection: torch.Tensor, depth: torch.Tensor) -> None:
        self.state = integrate(self.state, self.voxel_dim, self.voxel_size, self.origin,
                               self.trunc_margin, projection, depth)

    def get_tsdf(self) -> torch.Tensor:
        """The fused (nx, ny, nz) TSDF volume: sums over weights where
        touched, else the accumulator (the init's +1 or a far-side copy)."""
        s = self.state
        vol = torch.where(s.weight > 0, s.tsdf / torch.clamp(s.weight, min=1.0), s.tsdf)
        return vol.reshape(self.voxel_dim)


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
