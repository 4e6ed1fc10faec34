"""Bilinear plane and trilinear volume sampling (counterpart of
gennerf_tpu/ops/interpolation.py).

Built from gathers and lerps rather than F.grid_sample: the gradient losses
of later slices need second derivatives through the sampler, which cuDNN's
grid_sample lacks. Conventions are grid_sample's with padding_mode='border'
and align_corners=True: coords in [-1, 1], grid[..., 0] indexes width.

`trilinear_interpolation` samples a channels-last volume by one of two
routes, chosen from what the call can observe before any work
(`volume_kernel_takes`):

- the hand-written kernel csrc/volume_sample.cu (`trilinear_interpolation_cuda`)
  for bilinear mode with the volume and the points on CUDA, a float32 or
  bfloat16 volume, float32 points and no autograd graph to build (grad mode
  off, or no input requiring grad): one pass that reads each point's 8 corner
  rows and writes its features once, bit-equal to the composition on the
  same card;
- the composition of gathers and lerps (`trilinear_interpolation_plain`)
  for every other call: CPU tensors, a graph to build (training's decode,
  `decode_with_grad`'s double backward), float64, nearest mode.

The XLA the JAX package runs fuses the composition into one pass on the
TPU; the kernel is that pass on the card. Counters: `trilinear.points`
(every call's points) and `trilinear.kernel_points` (those the kernel
sampled).
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.spans import count
from . import kernels


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


def volume_kernel_takes(voxel_volume: torch.Tensor, xyz: torch.Tensor, origin=None,
                        mode: str = "bilinear") -> bool:
    """Whether `trilinear_interpolation` runs the kernel for these inputs:
    bilinear mode, both tensors on CUDA, a float32 or bfloat16 volume,
    float32 points, and no autograd graph to build (grad mode off, or none
    of the volume, the points and a tensor `origin` requires grad). Reads
    the tensors' metadata only."""
    needs_graph = torch.is_grad_enabled() and any(
        getattr(t, "requires_grad", False) for t in (voxel_volume, xyz, origin))
    return (mode == "bilinear" and voxel_volume.device.type == "cuda"
            and xyz.device.type == "cuda"
            and voxel_volume.dtype in (torch.float32, torch.bfloat16)
            and xyz.dtype == torch.float32 and not needs_graph)


def trilinear_interpolation(voxel_volume: torch.Tensor, xyz: torch.Tensor, origin,
                            voxel_size: float, mode: str = "bilinear") -> torch.Tensor:
    """A channels-last (B, nx, ny, nz, C) volume sampled at (B, N, 3) world
    points -> (B, N, C): points normalized by the volume extent
    (dim * voxel_size) from `origin` (the world position of voxel 0), border
    clamping, align_corners. The kernel where `volume_kernel_takes`, the
    composition otherwise (see the module docstring)."""
    kernel = volume_kernel_takes(voxel_volume, xyz, origin, mode)
    points = xyz.shape[0] * xyz.shape[1]
    count("trilinear.points", points)
    count("trilinear.kernel_points", points if kernel else 0)
    if kernel:
        return trilinear_interpolation_cuda(voxel_volume.contiguous(), xyz.contiguous(), origin,
                                            voxel_size)
    return trilinear_interpolation_plain(voxel_volume, xyz, origin, voxel_size, mode)


def trilinear_interpolation_plain(voxel_volume: torch.Tensor, xyz: torch.Tensor, origin,
                                  voxel_size: float, mode: str = "bilinear") -> torch.Tensor:
    """trilinear_interpolation as a composition of torch ops (differentiable
    twice; any device and dtype)."""
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


def trilinear_interpolation_cuda(voxel_volume: torch.Tensor, xyz: torch.Tensor, origin,
                                 voxel_size: float) -> torch.Tensor:
    """trilinear_interpolation's bilinear mode through csrc/volume_sample.cu:
    (B, N, C) float32, bit-equal to `trilinear_interpolation_plain` on the
    same card. `origin` (3 values, the world position of voxel 0) is read
    on the device; the extents are rounded on the host as the composition
    rounds f32(n) * voxel_size. Raises ValueError before any launch unless
    the volume is a contiguous (B, nx, ny, nz, C) float32 or bfloat16
    tensor (each of nx, ny, nz and C an int32) and the points contiguous
    (B, N, 3) float32, all on one CUDA device."""
    if (voxel_volume.dim() != 5 or min(voxel_volume.shape[1:]) < 1
            or max(voxel_volume.shape[1:]) > 2 ** 31 - 1):
        raise ValueError(f"voxel_volume: expected (B, nx, ny, nz, C) with nx, ny, nz, C in "
                         f"[1, 2^31), got {tuple(voxel_volume.shape)}")
    if xyz.dim() != 3 or xyz.shape[2] != 3 or xyz.shape[0] != voxel_volume.shape[0]:
        raise ValueError(f"xyz: expected (B, N, 3) with the volume's B = "
                         f"{voxel_volume.shape[0]}, got {tuple(xyz.shape)}")
    if voxel_volume.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"voxel_volume: expected float32 or bfloat16, got {voxel_volume.dtype}")
    if xyz.dtype != torch.float32:
        raise ValueError(f"xyz: expected float32, got {xyz.dtype}")
    for t, name in ((voxel_volume, "voxel_volume"), (xyz, "xyz")):
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
    B, nx, ny, nz, C = voxel_volume.shape
    N = xyz.shape[1]
    origin = torch.as_tensor(origin, dtype=torch.float32, device=xyz.device).reshape(-1)
    if origin.numel() < 3:
        raise ValueError(f"origin: expected 3 values, got {origin.numel()}")
    origin = origin[:3].contiguous()
    for t, name in ((voxel_volume, "voxel_volume"), (xyz, "xyz"), (origin, "origin")):
        if t.device.type != "cuda" or t.device != xyz.device:
            raise ValueError(f"{name}: expected a CUDA tensor on {xyz.device}, got {t.device}")
    out = torch.empty((B, N, C), dtype=torch.float32, device=xyz.device)
    if out.numel() == 0:
        return out
    ex, ey, ez = (float(np.float32(n) * np.float32(voxel_size)) for n in (nx, ny, nz))
    kernels.VOLUME_SAMPLE.launch(
        voxel_volume.data_ptr(), int(voxel_volume.dtype == torch.bfloat16), xyz.data_ptr(),
        origin.data_ptr(), out.data_ptr(), B, N, nx, ny, nz, C, ex, ey, ez,
        kernels.stream_ptr(xyz.device))
    return out


def sample_plane_feature(planes: torch.Tensor, p_norm: torch.Tensor,
                         mode: str = "bilinear") -> torch.Tensor:
    """(B, C, reso, reso) plane sampled at (B, N, 2) normalized coords in
    [0, 1) -> (B, N, C); the first coord indexes width, the second height."""
    vgrid = 2.0 * p_norm - 1.0
    out = grid_sample_2d(planes, vgrid[:, :, None, :], mode=mode)  # (B, C, N, 1)
    return out[..., 0].permute(0, 2, 1)
