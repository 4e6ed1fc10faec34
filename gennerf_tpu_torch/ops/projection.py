"""Camera projection / unprojection (counterpart of gennerf_tpu/ops/projection.py)."""
from __future__ import annotations

import torch

from .coords import world_coordinates


def homogenize_projection(projection: torch.Tensor) -> torch.Tensor:
    """(..., 3, 4) world->image projection -> (..., 4, 4) with a [0,0,0,1] row."""
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=projection.dtype, device=projection.device)
    bottom = bottom.expand(*projection.shape[:-2], 1, 4)
    return torch.cat([projection, bottom], dim=-2)


def get_3d_points(depth: torch.Tensor, projection: torch.Tensor) -> torch.Tensor:
    """Unproject (B, H, W) depth maps through (B, 3, 4) world->image
    projections: pixel (u, v) with depth d maps through inv([P; 0 0 0 1])
    applied to (u*d, v*d, d, 1). Returns (B, H, W, 3) world points
    (the camera center where depth == 0)."""
    B, H, W = depth.shape
    u = torch.arange(W, dtype=depth.dtype, device=depth.device)[None, :].expand(H, W)
    v = torch.arange(H, dtype=depth.dtype, device=depth.device)[:, None].expand(H, W)
    uv1 = torch.stack([u, v, torch.ones_like(u)], dim=-1)  # (H, W, 3)
    pts_img = uv1[None] * depth[..., None]
    pts_img_h = torch.cat([pts_img, torch.ones_like(pts_img[..., :1])], dim=-1)
    inv_proj = torch.linalg.inv(homogenize_projection(projection))  # (B, 4, 4)
    pts_world_h = torch.einsum("bhwj,bij->bhwi", pts_img_h, inv_proj)
    return pts_world_h[..., :3] / pts_world_h[..., 3:4]


def project_voxels(voxel_dim, voxel_size: float, origin, projection: torch.Tensor,
                   height: int, width: int):
    """Project every voxel center of the grid through (B, 3, 4) projections,
    rounding to the nearest pixel.

    Returns px, py (B, V) int64 clamped in-bounds, pz (B, V) camera depth,
    valid (B, V) bool: inside the image with pz > 0."""
    origin = torch.as_tensor(origin, dtype=torch.float32, device=projection.device)
    world = world_coordinates(voxel_dim, voxel_size, origin)
    world_h = torch.cat([world, torch.ones_like(world[:1])], dim=0)  # (4, V)
    camera = torch.einsum("bij,jv->biv", projection, world_h)  # (B, 3, V)
    z = camera[:, 2]
    safe_z = torch.where(z == 0, torch.full_like(z, 1e-8), z)
    px = torch.round(camera[:, 0] / safe_z).to(torch.int64)
    py = torch.round(camera[:, 1] / safe_z).to(torch.int64)
    valid = (px >= 0) & (py >= 0) & (px < width) & (py < height) & (z > 0)
    return px.clamp(0, width - 1), py.clamp(0, height - 1), z, valid
