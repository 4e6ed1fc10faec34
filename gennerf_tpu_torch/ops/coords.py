"""Voxel-grid coordinate helpers (counterpart of gennerf_tpu/ops/coords.py)."""
from __future__ import annotations

import torch


def linspace(start: float, stop: float, num: int, device=None) -> torch.Tensor:
    """float32 linspace rounded as the reference's compiled jnp.linspace:
    with r = f32(1/(num-1)), point i < num-1 is start*(1 - i*r) + i*(stop*r)
    and the last point is exactly `stop` (torch.linspace rounds otherwise,
    which moves grid coordinates by an ulp)."""
    f32 = torch.float32
    start_t = torch.tensor(start, dtype=f32, device=device)
    stop_t = torch.tensor(stop, dtype=f32, device=device)
    if num == 1:
        return start_t.reshape(1)
    r = torch.tensor(1.0, dtype=f32, device=device) / (num - 1)
    iota = torch.arange(num - 1, dtype=f32, device=device)
    out = start_t * (1 - iota * r) + iota * (stop_t * r)
    return torch.cat([out, stop_t.reshape(1)])


def coordinates(voxel_dim, device=None) -> torch.Tensor:
    """(3, nx*ny*nz) int64 voxel indices, x-major (index = x*ny*nz + y*nz + z)."""
    nx, ny, nz = (int(d) for d in voxel_dim)
    x, y, z = torch.meshgrid(
        torch.arange(nx, device=device), torch.arange(ny, device=device),
        torch.arange(nz, device=device), indexing="ij",
    )
    return torch.stack((x.reshape(-1), y.reshape(-1), z.reshape(-1)))


def world_coordinates(voxel_dim, voxel_size: float, origin) -> torch.Tensor:
    """(3, V) float32 world positions of voxel centers: coords*voxel_size + origin."""
    origin = torch.as_tensor(origin, dtype=torch.float32).reshape(3, 1)
    return coordinates(voxel_dim, origin.device).to(torch.float32) * voxel_size + origin


def grid_coordinates(nx: int, ny: int, nz: int, volume_size, device=None) -> torch.Tensor:
    """(nx, ny, nz, 3) float32 dense query grid spanning [0, volume_size]
    per axis, endpoints inclusive."""
    x = linspace(0.0, float(volume_size[0]), nx, device)
    y = linspace(0.0, float(volume_size[1]), ny, device)
    z = linspace(0.0, float(volume_size[2]), nz, device)
    gx, gy, gz = torch.meshgrid(x, y, z, indexing="ij")
    return torch.stack([gx, gy, gz], dim=-1)


_PLANE_AXES = {"xz": (0, 2), "xy": (0, 1), "yz": (1, 2)}


def normalize_coordinate(p: torch.Tensor, padding: float = 0.1, plane: str = "xz") -> torch.Tensor:
    """(..., 3) points -> (..., 2) coords of `plane` in [0, 1 - 1e-5]:
    divide by (1 + padding + 1e-5), shift by 0.5, clamp (ConvONet)."""
    if plane not in _PLANE_AXES:
        raise ValueError(f"unknown plane {plane!r}")
    xy = p[..., list(_PLANE_AXES[plane])]
    xy = xy / (1.0 + padding + 10e-6) + 0.5
    return xy.clamp(0.0, 1.0 - 10e-6)


def coordinate2index(x: torch.Tensor, reso: int, coord_type: str = "2d") -> torch.Tensor:
    """Normalized coords in [0,1) -> flat cell indices (int64):
    `x0 + reso*x1` for planes, `x0 + reso*(x1 + reso*x2)` for grids."""
    xi = (x * reso).to(torch.int64)
    if coord_type == "2d":
        return xi[..., 0] + reso * xi[..., 1]
    if coord_type == "3d":
        return xi[..., 0] + reso * (xi[..., 1] + reso * xi[..., 2])
    raise ValueError(coord_type)
