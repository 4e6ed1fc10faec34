"""Camera projection / unprojection (counterpart of gennerf_tpu/ops/projection.py)."""
from __future__ import annotations

import torch

from ..utils.spans import count, span
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


def depth_to_world(projection: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Unproject one (H, W) depth map through its (3, 4) projection:
    (3, H*W) world points, row-major over the pixels."""
    return get_3d_points(depth[None], projection[None])[0].reshape(-1, 3).T


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
    return camera_pixels(camera, height, width)


def camera_pixels(camera: torch.Tensor, height: int, width: int):
    """Round (B, 3, V) camera coordinates to pixels, as `project_voxels`
    returns them."""
    z = camera[:, 2]
    safe_z = torch.where(z == 0, torch.full_like(z, 1e-8), z)
    px = torch.round(camera[:, 0] / safe_z).to(torch.int64)
    py = torch.round(camera[:, 1] / safe_z).to(torch.int64)
    valid = (px >= 0) & (py >= 0) & (px < width) & (py < height) & (z > 0)
    return px.clamp(0, width - 1), py.clamp(0, height - 1), z, valid


def backproject(voxel_dim, voxel_size: float, origin, projection: torch.Tensor,
                features: torch.Tensor):
    """Lift (B, C, H, W) features along camera rays into the voxel grid:
    each voxel center projects through its frame's (B, 3, 4) world->pixel
    projection and reads the feature of the pixel it rounds to (one dense
    gather per voxel, not a scatter).

    Returns volume (B, C, nx, ny, nz), 0 outside the frustum, and valid
    (B, 1, nx, ny, nz) float {0, 1}."""
    B, C, H, W = features.shape
    nx, ny, nz = (int(d) for d in voxel_dim)
    origin = torch.as_tensor(origin, dtype=torch.float32, device=features.device).reshape(-1)[:3]
    px, py, _, valid = project_voxels(voxel_dim, voxel_size, origin, projection, H, W)
    flat_idx = py * W + px  # (B, V)
    flat = features.reshape(B, C, H * W)
    # index_select along the pixel axis: its backward is one index_add per
    # frame (deterministic on CUDA under torch.use_deterministic_algorithms)
    cols = [flat[b].index_select(1, flat_idx[b]) for b in range(B)]
    vol = cols[0][None] if B == 1 else torch.stack(cols)
    vol = torch.where(valid[:, None, :], vol, torch.zeros((), dtype=vol.dtype, device=vol.device))
    return vol.reshape(B, C, nx, ny, nz), valid.to(features.dtype).reshape(B, 1, nx, ny, nz)


def backproject_fold(feat_2d: torch.Tensor, projection: torch.Tensor, image_hw, voxel_dim,
                     voxel_size: float, origin):
    """Sum the backprojected features of T frames into one volume.

    Args:
        feat_2d: (B*T, C, Hf, Wf) features of the folded frame axis.
        projection: (B, T, 3, 4) world->image-pixel projections, rescaled
            here to feature pixels by (Wf/W, Hf/H, 1).
        image_hw: (H, W) of the images the projections address.

    Returns (volume (B, C, nx, ny, nz), valid (B, 1, nx, ny, nz)), both f32
    running sums accumulated frame by frame."""
    B, T = projection.shape[:2]
    C, Hf, Wf = feat_2d.shape[1:]
    H, W = (int(s) for s in image_hw)
    with span("gennerf.backproject"):
        scale = torch.tensor([Wf / W, Hf / H, 1.0], dtype=torch.float32,
                             device=projection.device).reshape(1, 3, 1)
        feat = feat_2d.to(torch.float32).reshape(B, T, C, Hf, Wf)
        volume = valid = None
        for t in range(T):
            vol, val = backproject(voxel_dim, voxel_size, origin, projection[:, t] * scale,
                                   feat[:, t])
            volume = vol if volume is None else volume + vol
            valid = val if valid is None else valid + val
        count("backproject.pairs", B * T * valid[0, 0].numel())
        count("backproject.observed", valid)
        return volume, valid
