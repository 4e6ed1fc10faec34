"""TSDF fusion of posed depth maps, with the colour and label channels, and
the fusion prior of inference (counterpart of gennerf_tpu/tsdf/fusion.py:
`integrate`, `fuse_frames`, `TSDFFusion`, `_prior_classes`,
`apply_fusion_prior`).

Fusion semantics, per frame: voxels in the frustum with valid depth and
dist = max((pz - d) / trunc_margin, -1) < 1 are valid; a first touch
(weight 0) copies dist, later touches accumulate it only in the
near-surface band (dist > -1), whose touches the weight counts; the fused
TSDF divides the sum by the weight. The colour channel sums the pixel's
colour over the band's touches (divided by the weight too), the label
channel keeps the newest band touch's label (-1: none). Everything is
torch on the tensors' device, one frame at a time.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops.projection import camera_pixels, project_voxels, world_coordinates
from ..utils.spans import count, span
from .tsdf import TSDF


class FusionState(NamedTuple):
    """Dense fusion accumulators, flat over V = nx*ny*nz voxels."""

    tsdf: torch.Tensor    # (V,) accumulated truncated distances
    weight: torch.Tensor  # (V,) near-surface observation count
    color: Optional[torch.Tensor] = None  # (3, V) accumulated colours
    label: Optional[torch.Tensor] = None  # (V,) int32 newest label, -1 = none


def init_state(voxel_dim, device=None, color: bool = False, label: bool = False) -> FusionState:
    V = int(voxel_dim[0]) * int(voxel_dim[1]) * int(voxel_dim[2])
    return FusionState(
        torch.ones(V, dtype=torch.float32, device=device),
        torch.zeros(V, dtype=torch.float32, device=device),
        torch.zeros(3, V, dtype=torch.float32, device=device) if color else None,
        torch.full((V,), -1, dtype=torch.int32, device=device) if label else None)


def _frame_pixels(voxel_dim, voxel_size: float, origin, projection: torch.Tensor,
                  height: int, width: int):
    """`project_voxels` for one (3, 4) projection, with pixels that do not
    depend on the device: the camera coordinates are summed term by term
    in a fixed order, each float32 x float32 product exact in float64 and
    each partial sum rounded to float64 then to float32. A matrix product
    sums in an order (and with fused multiply-adds) of its library's
    choosing, which can move a voxel on a pixel border to the neighbouring
    pixel on one device and not on the other; these elementwise IEEE steps
    give the same bits on both, so fusion on the card equals fusion on the
    CPU. The shared `project_voxels` (the encoders' backprojection) keeps
    its one matrix product."""
    origin = torch.as_tensor(origin, dtype=torch.float32, device=projection.device)
    world = world_coordinates(voxel_dim, voxel_size, origin).double()  # (3, V)
    proj = projection.double()
    camera = (proj[:, 0:1] * world[0]).float()
    for k in range(1, 3):
        camera = (proj[:, k:k + 1] * world[k] + camera.double()).float()
    camera = (proj[:, 3:4] + camera.double()).float()
    px, py, pz, in_view = camera_pixels(camera[None], height, width)
    return px[0], py[0], pz[0], in_view[0]


@torch.no_grad()
def integrate(state: FusionState, voxel_dim, voxel_size: float, origin, trunc_margin: float,
              projection: torch.Tensor, depth: torch.Tensor,
              color: Optional[torch.Tensor] = None,
              label: Optional[torch.Tensor] = None) -> FusionState:
    """Accumulate one (H, W) depth frame (0 = invalid) seen through a
    (3, 4) world->image projection, with its (3, H, W) colours and (H, W)
    labels where the state has those channels and they are given."""
    H, W = depth.shape
    px, py, pz, in_view = _frame_pixels(voxel_dim, voxel_size, origin, projection, H, W)
    d = depth[py, px]
    # a true division on any device: CUDA divides by a host scalar as a
    # multiply by its reciprocal, an ulp off the CPU's quotient
    trunc = torch.tensor(trunc_margin, dtype=pz.dtype, device=pz.device)
    dist = torch.clamp((pz - d) / trunc, min=-1.0)
    valid = in_view & (d > 0) & (dist < 1)
    first_touch = state.weight == 0
    tsdf = torch.where(valid & first_touch, dist, state.tsdf)
    near = valid & (dist > -1)
    tsdf = torch.where(near & ~first_touch, tsdf + dist, tsdf)
    new_color, new_label = state.color, state.label
    if state.color is not None and color is not None:
        new_color = state.color + torch.where(near[None], color[:, py, px].float(), 0.0)
    if state.label is not None and label is not None:
        new_label = torch.where(near, label[py, px].to(torch.int32), state.label)
    return FusionState(tsdf, state.weight + near.to(state.weight.dtype), new_color, new_label)


@torch.no_grad()
def fuse_frames(voxel_dim, voxel_size: float, origin, trunc_margin: float,
                projections: torch.Tensor, depths: torch.Tensor,
                colors: Optional[torch.Tensor] = None, labels: Optional[torch.Tensor] = None,
                use_color: bool = False, use_label: bool = False) -> FusionState:
    """Fuse (T, 3, 4) projections and (T, H, W) depths frame by frame, with
    (T, 3, H, W) colours under `use_color` and (T, H, W) labels under
    `use_label`."""
    state = init_state(voxel_dim, depths.device, use_color, use_label)
    for t, (projection, depth) in enumerate(zip(projections, depths)):
        state = integrate(state, voxel_dim, voxel_size, origin, trunc_margin, projection, depth,
                          colors[t] if use_color else None, labels[t] if use_label else None)
    return state


class TSDFFusion:
    """Stateful wrapper carrying the accumulators between `integrate` calls
    on `device`; `color` and `label` keep those channels (the reference's
    defaults: colour on, labels off)."""

    def __init__(self, voxel_dim=(128, 128, 128), voxel_size: float = 0.02,
                 origin=(0.0, 0.0, 0.0), trunc_ratio: float = 3, color: bool = True,
                 label: bool = False, device=None):
        self.voxel_dim = tuple(int(d) for d in voxel_dim)
        self.voxel_size = float(voxel_size)
        self.origin = torch.as_tensor(origin, dtype=torch.float32, device=device).reshape(3)
        self.trunc_margin = self.voxel_size * trunc_ratio
        self.state = init_state(self.voxel_dim, device, color, label)

    def integrate(self, projection: torch.Tensor, depth: torch.Tensor,
                  color: Optional[torch.Tensor] = None,
                  label: Optional[torch.Tensor] = None) -> None:
        self.state = integrate(self.state, self.voxel_dim, self.voxel_size, self.origin,
                               self.trunc_margin, projection, depth, color, label)

    def get_tsdf(self, label_name: str = "instance") -> TSDF:
        """The fused volume as a `TSDF` at this fusion's origin: the TSDF
        and colour sums over the weights where touched, else the
        accumulator (the init's +1 or a far-side copy; colour 0), and the
        labels as the attribute volume `label_name`. Tensors stay on the
        fusion's device."""
        s = self.state
        touched = s.weight > 0
        weight = torch.clamp(s.weight, min=1.0)
        vol = torch.where(touched, s.tsdf / weight, s.tsdf)
        attribute_vols = {}
        if s.color is not None:
            color = torch.where(touched[None], s.color / weight[None], s.color)
            attribute_vols["color"] = color.reshape(3, *self.voxel_dim)
        if s.label is not None:
            attribute_vols[label_name] = s.label.reshape(self.voxel_dim)
        return TSDF(self.voxel_size, self.origin.reshape(1, 3), vol.reshape(self.voxel_dim),
                    attribute_vols)


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
    with span("gennerf.prior"):
        near, farfront = prior_classes(voxel_dim, float(voxel_size), origin,
                                       float(voxel_size) * trunc_ratio, projections, depths)
        count("prior.kept_voxels", near)
        flat = tsdf_vol.reshape(-1)
        one = torch.ones((), dtype=flat.dtype, device=flat.device)
        return torch.where(near, flat, torch.where(farfront, -one, one)).reshape(voxel_dim)
