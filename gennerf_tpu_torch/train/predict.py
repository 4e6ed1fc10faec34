"""Dense TSDF decoding (counterpart of gennerf_tpu/train/predict.py).

`predict_tsdf_volume` makes one static choice from the config: a
triplane-only decoder the separable formulation supports, with a zero head
bias, goes to the separable grid decode (the CUDA kernel on the card);
every other config goes to the chunked per-point `decode_dense`. There is
no fall-through on runtime errors: a kernel that fails raises.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..models.gen_nerf import GenNerf, SceneRepr
from ..ops.coords import grid_coordinates
from ..ops.grid_decode import (
    extract_resnetfc_weights,
    grid_decode,
    grid_tables,
    supports_grid_decode,
)


def dense_grid_points(voxel_dim, voxel_size: float, origin, device=None) -> torch.Tensor:
    """(nx*ny*nz, 3) query grid: linspace over voxel_size*voxel_dim per
    axis, endpoints inclusive, shifted by origin."""
    nx, ny, nz = (int(d) for d in voxel_dim)
    grid = grid_coordinates(nx, ny, nz, [voxel_size * d for d in (nx, ny, nz)], device)
    return grid.reshape(-1, 3) + torch.as_tensor(origin, dtype=torch.float32, device=device).reshape(1, 3)


@torch.no_grad()
def decode_dense(model: GenNerf, repr_: SceneRepr, points: torch.Tensor,
                 chunk_size: int = 32768) -> torch.Tensor:
    """TSDF at (N, 3) points of one scene, chunk by chunk -> (N,) f32."""
    out = [model.decode(repr_, chunk[None])["tsdf"][0, :, 0]
           for chunk in torch.split(points, chunk_size)]
    return torch.cat(out).to(torch.float32)


def uses_grid_decode(model: GenNerf) -> bool:
    """The static dispatch: separable grid decode for triplane-only scenes
    of a supported decoder with a zero head bias."""
    cfg = model.cfg
    return (
        supports_grid_decode(cfg)
        and set(cfg.encoder.pointnet.plane_type) == {"xz", "xy", "yz"}
        and cfg.encoder.pointnet.sample_mode == "bilinear"
        and float(model.head_geo.fc.bias.detach()[0]) == 0.0
    )


@torch.no_grad()
def decode_grid(model: GenNerf, repr_: SceneRepr, voxel_dim, voxel_size: float,
                origin) -> torch.Tensor:
    """Dense decode through the separable tables and the grid decode."""
    cfg = model.cfg
    planes = repr_.planes
    if planes["xz"].shape[0] != 1:
        raise ValueError("grid decode handles one scene at a time")
    weights = extract_resnetfc_weights(model.mlp, model.head_geo, cfg.mlp.d_out_geo,
                                       cfg.mlp.head_smoothing)
    coord_center = coord_scale = None
    if cfg.encoder.pointnet.normalize_coords:
        extent = [d * cfg.voxel_size for d in cfg.voxel_dim_train]
        coord_center = tuple(e / 2.0 for e in extent)
        coord_scale = float(max(extent))
    tables = grid_tables(
        planes["xz"][0], planes["xy"][0], planes["yz"][0], origin, weights,
        voxel_dim=tuple(int(d) for d in voxel_dim), voxel_size=float(voxel_size),
        num_freqs=cfg.code.num_freqs, freq_factor=float(cfg.code.freq_factor),
        include_input=bool(cfg.code.include_input), padding=float(cfg.encoder.pointnet.padding),
        coord_center=coord_center, coord_scale=coord_scale,
    )
    return grid_decode(tables, weights)


@torch.no_grad()
def predict_tsdf_volume(model: GenNerf, repr_: SceneRepr, voxel_dim: Tuple[int, int, int],
                        voxel_size: float, origin, chunk_size: int = 32768) -> torch.Tensor:
    """Dense (nx, ny, nz) f32 TSDF volume of one scene."""
    device = repr_.planes["xz"].device
    if uses_grid_decode(model):
        return decode_grid(model, repr_, voxel_dim, voxel_size, origin)
    pts = dense_grid_points(voxel_dim, voxel_size, origin, device)
    return decode_dense(model, repr_, pts, chunk_size).reshape(tuple(int(d) for d in voxel_dim))
