"""Local-pooling PointNet triplane encoder and the plane merger
(counterpart of gennerf_tpu/models/pointnet.py). Parameter names follow the
reference checkpoint (pointnet.fc_pos / blocks.{i} / fc_c / unet, and
merger.conv for the learned merger); the grid's 3D U-Net is
pointnet.unet3d (models/unet3d.py).

The 'grid' plane type scatters the mean of the final features onto a
grid_resolution^3 grid (the flat index x0 + r*(x1 + r*x2) of
normalize_3d_coordinate), returned as (B, C, x0, x1, x2) and smoothed by
the 3D U-Net with `use_unet3d`; the local pooling pools over its cells
too. The 2D planes keep their shared UNet.

Under a compute `dtype` (bf16-mixed) the layers, the blocks and the UNet
compute in it as the JAX encoder's do: fc_pos casts the float32 points,
the cell indices come from the float32 points, the pooling runs in the
features' dtype, the plane scatter sums in float32 and its mean (over
float32 counts) is float32, so the UNet casts its input back; the planes
come out in the compute dtype."""
from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from ..ops.coords import coordinate2index, normalize_3d_coordinate, normalize_coordinate
from ..ops.scatter import pool_and_gather, scatter_to_plane, segment_mean
from .resnet import Conv2d, cast_conv
from .resnetfc import ResnetBlockFC, linear
from .unet import UNet
from .unet3d import UNet3D


class LocalPoolPointnet(nn.Module):
    """(B, N, 3) points -> dict plane -> (B, c_dim, reso, reso).

    A per-point MLP of ResNet FC blocks, each after the first fed the
    scatter-pooled features of the point's cells on every plane; final
    features are scatter-averaged onto the planes and smoothed by ONE UNet
    shared across them (one batched pass over the 3B planes)."""

    def __init__(self, c_dim: int = 128, dim: int = 3, hidden_dim: int = 128,
                 scatter_type: str = "max", use_unet: bool = False, unet_depth: int = 5,
                 unet_merge_mode: str = "concat", unet_start_filts: int = 32,
                 plane_resolution: int = 128, grid_resolution: int = 32,
                 plane_type: Sequence[str] = ("xz", "xy", "yz"), padding: float = 0.1,
                 n_blocks: int = 5, use_unet3d: bool = False, unet3d_f_maps: int = 32,
                 unet3d_num_levels: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.scatter_type, self.padding = scatter_type, padding
        self.reso, self.grid_reso = plane_resolution, grid_resolution
        self.plane_type = tuple(plane_type)
        self.fc_pos = linear(dim, 2 * hidden_dim, dtype=dtype)
        self.blocks = nn.ModuleList(
            [ResnetBlockFC(2 * hidden_dim, hidden_dim, dtype=dtype) for _ in range(n_blocks)])
        self.fc_c = linear(hidden_dim, c_dim, dtype=dtype)
        # the JAX UNet has parameters only where it runs: on the 2D planes
        self.unet = (
            UNet(c_dim, in_channels=c_dim, depth=unet_depth, start_filts=unet_start_filts,
                 merge_mode=unet_merge_mode, dtype=dtype)
            if use_unet and set(self.plane_type) - {"grid"} else None
        )
        self.unet3d = (UNet3D(c_dim, c_dim, unet3d_f_maps, unet3d_num_levels)
                       if use_unet3d and "grid" in self.plane_type else None)

    def forward(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        reso, greso = self.reso, self.grid_reso
        index, cells = {}, {}
        for plane in self.plane_type:
            if plane == "grid":
                index[plane] = coordinate2index(normalize_3d_coordinate(p, self.padding), greso,
                                                coord_type="3d")
                cells[plane] = greso ** 3
            else:
                index[plane] = coordinate2index(normalize_coordinate(p, self.padding, plane), reso)
                cells[plane] = reso * reso
        net = self.blocks[0](self.fc_pos(p))
        for block in self.blocks[1:]:
            pooled = 0
            for plane in self.plane_type:
                pooled = pooled + pool_and_gather(net, index[plane], cells[plane],
                                                  self.scatter_type)
            net = block(torch.cat([net, pooled], dim=-1))
        c = self.fc_c(net)
        fea = {}
        if "grid" in self.plane_type:
            B, C = c.shape[0], c.shape[-1]
            # flat index x0 + r*(x1 + r*x2): (B, x2, x1, x0, C) -> (B, C, x0, x1, x2)
            vol = segment_mean(c, index["grid"], greso ** 3).reshape(B, greso, greso, greso, C)
            vol = vol.permute(0, 4, 3, 2, 1)
            fea["grid"] = vol if self.unet3d is None else self.unet3d(vol)
        flat = [pl for pl in self.plane_type if pl != "grid"]
        planes = [scatter_to_plane(c, index[pl], reso, reduce="mean") for pl in flat]
        if self.unet is not None:
            B = p.shape[0]
            smoothed = self.unet(torch.cat(planes, dim=0))
            planes = [smoothed[i * B:(i + 1) * B] for i in range(len(planes))]
        fea.update(zip(flat, planes))
        return fea


class FeaturePlaneMerger(nn.Module):
    """Merge triplane dicts of successive encodes: alpha*new + (1-alpha)*old
    ('average'; the weights are tensors of the planes' dtype, as JAX rounds
    its weak-typed floats), or 'learn': one 1x1 conv (`conv`, the
    reference's merger.conv) over each plane's channel concatenation
    [new, old], 2*c_dim -> c_dim, shared by the planes."""

    def __init__(self, strategy: str = "average", alpha: float = 0.5, c_dim: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if strategy not in ("average", "learn"):
            raise NotImplementedError(f"plane merger strategy {strategy!r}")
        self.strategy, self.alpha = strategy, float(alpha)
        if strategy == "learn":
            self.conv = cast_conv(Conv2d, 2 * c_dim, c_dim, 1, dtype=dtype)

    def forward(self, plane_1: Dict[str, torch.Tensor], plane_2: Dict[str, torch.Tensor]):
        if self.strategy == "learn":
            if any(plane_1[k].dim() != 4 for k in plane_1):
                raise NotImplementedError("the learned plane merger takes 2D planes only")
            return {k: self.conv(torch.cat([plane_1[k], plane_2[k]], dim=1)) for k in plane_1}

        def weight(w, like):
            return torch.tensor(w, dtype=like.dtype, device=like.device)

        return {k: weight(self.alpha, plane_1[k]) * plane_1[k]
                + weight(1 - self.alpha, plane_2[k]) * plane_2[k] for k in plane_1}
