"""Bilinear plane and trilinear volume sampling (counterpart of
gennerf_tpu/ops/interpolation.py).

Built from gathers and lerps rather than F.grid_sample: the gradient losses
of later slices need second derivatives through the sampler, which cuDNN's
grid_sample lacks. Conventions are grid_sample's with padding_mode='border'
and align_corners=True: coords in [-1, 1], grid[..., 0] indexes width.
"""
from __future__ import annotations

import torch


def _unnormalize(coord: torch.Tensor, size: int, align_corners: bool = True) -> torch.Tensor:
    if align_corners:
        return (coord + 1.0) * 0.5 * (size - 1)
    return ((coord + 1.0) * size - 1.0) * 0.5


def grid_sample_2d(image: torch.Tensor, grid: torch.Tensor, mode: str = "bilinear",
                   align_corners: bool = True) -> torch.Tensor:
    """(B, C, IH, IW) image sampled at (B, H, W, 2) grid -> (B, C, H, W)."""
    B, C, IH, IW = image.shape
    _, H, W, _ = grid.shape
    ix = _unnormalize(grid[..., 0], IW, align_corners)
    iy = _unnormalize(grid[..., 1], IH, align_corners)
    flat = image.permute(0, 2, 3, 1).reshape(B, IH * IW, C)

    def gather(yi, xi):
        idx = (yi.clamp(0, IH - 1) * IW + xi.clamp(0, IW - 1)).reshape(B, H * W, 1)
        vals = torch.gather(flat, 1, idx.expand(B, H * W, C))
        return vals.reshape(B, H, W, C).permute(0, 3, 1, 2)

    if mode == "nearest":
        return gather(torch.round(iy).to(torch.int64), torch.round(ix).to(torch.int64))
    x0 = torch.floor(ix)
    y0 = torch.floor(iy)
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    wx = (ix - x0)[:, None]
    wy = (iy - y0)[:, None]
    v00 = gather(y0i, x0i)
    v01 = gather(y0i, x0i + 1)
    v10 = gather(y0i + 1, x0i)
    v11 = gather(y0i + 1, x0i + 1)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


def trilinear_interpolation(voxel_volume: torch.Tensor, xyz: torch.Tensor, origin,
                            voxel_size: float, mode: str = "bilinear") -> torch.Tensor:
    """A channels-last (B, nx, ny, nz, C) volume sampled at (B, N, 3) world
    points -> (B, N, C): points normalized by the volume extent
    (dim * voxel_size) from `origin` (the world position of voxel 0), border
    clamping, align_corners."""
    B, nx, ny, nz, C = voxel_volume.shape
    N = xyz.shape[1]
    origin = torch.as_tensor(origin, dtype=xyz.dtype, device=xyz.device).reshape(-1)[:3]
    extent = torch.tensor([nx, ny, nz], dtype=xyz.dtype, device=xyz.device) * voxel_size
    norm = 2.0 * (xyz - origin) / extent - 1.0
    ix = _unnormalize(norm[..., 0], nx)
    iy = _unnormalize(norm[..., 1], ny)
    iz = _unnormalize(norm[..., 2], nz)
    flat = voxel_volume.reshape(B, nx * ny * nz, C)

    def gather(xi, yi, zi):
        idx = ((xi.clamp(0, nx - 1) * ny + yi.clamp(0, ny - 1)) * nz + zi.clamp(0, nz - 1))
        return torch.gather(flat, 1, idx.reshape(B, N, 1).expand(B, N, C))

    if mode == "nearest":
        return gather(*(torch.round(i).to(torch.int64) for i in (ix, iy, iz)))
    x0, y0, z0 = torch.floor(ix), torch.floor(iy), torch.floor(iz)
    x0i, y0i, z0i = x0.to(torch.int64), y0.to(torch.int64), z0.to(torch.int64)
    wx, wy, wz = (ix - x0)[..., None], (iy - y0)[..., None], (iz - z0)[..., None]
    c00 = gather(x0i, y0i, z0i) * (1 - wz) + gather(x0i, y0i, z0i + 1) * wz
    c01 = gather(x0i, y0i + 1, z0i) * (1 - wz) + gather(x0i, y0i + 1, z0i + 1) * wz
    c10 = gather(x0i + 1, y0i, z0i) * (1 - wz) + gather(x0i + 1, y0i, z0i + 1) * wz
    c11 = gather(x0i + 1, y0i + 1, z0i) * (1 - wz) + gather(x0i + 1, y0i + 1, z0i + 1) * wz
    c0 = c00 * (1 - wy) + c01 * wy
    c1 = c10 * (1 - wy) + c11 * wy
    return c0 * (1 - wx) + c1 * wx


def sample_plane_feature(planes: torch.Tensor, p_norm: torch.Tensor,
                         mode: str = "bilinear") -> torch.Tensor:
    """(B, C, reso, reso) plane sampled at (B, N, 2) normalized coords in
    [0, 1) -> (B, N, C); the first coord indexes width, the second height."""
    vgrid = 2.0 * p_norm - 1.0
    out = grid_sample_2d(planes, vgrid[:, :, None, :], mode=mode)  # (B, C, N, 1)
    return out[..., 0].permute(0, 2, 1)
