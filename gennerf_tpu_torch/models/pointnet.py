"""Local-pooling PointNet triplane encoder and the plane merger
(counterpart of gennerf_tpu/models/pointnet.py). Parameter names follow the
reference checkpoint (pointnet.fc_pos / blocks.{i} / fc_c / unet).

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

from ..ops.coords import coordinate2index, normalize_coordinate
from ..ops.scatter import pool_and_gather, scatter_to_plane
from .resnetfc import ResnetBlockFC, linear
from .unet import UNet


class LocalPoolPointnet(nn.Module):
    """(B, N, 3) points -> dict plane -> (B, c_dim, reso, reso).

    A per-point MLP of ResNet FC blocks, each after the first fed the
    scatter-pooled features of the point's cells on every plane; final
    features are scatter-averaged onto the planes and smoothed by ONE UNet
    shared across them (one batched pass over the 3B planes)."""

    def __init__(self, c_dim: int = 128, dim: int = 3, hidden_dim: int = 128,
                 scatter_type: str = "max", use_unet: bool = False, unet_depth: int = 5,
                 unet_start_filts: int = 32, plane_resolution: int = 128,
                 plane_type: Sequence[str] = ("xz", "xy", "yz"), padding: float = 0.1,
                 n_blocks: int = 5, dtype: torch.dtype = torch.float32):
        super().__init__()
        if "grid" in plane_type:
            raise NotImplementedError("pointnet plane_type 'grid'")
        self.scatter_type, self.reso = scatter_type, plane_resolution
        self.plane_type, self.padding = tuple(plane_type), padding
        self.fc_pos = linear(dim, 2 * hidden_dim, dtype=dtype)
        self.blocks = nn.ModuleList(
            [ResnetBlockFC(2 * hidden_dim, hidden_dim, dtype=dtype) for _ in range(n_blocks)])
        self.fc_c = linear(hidden_dim, c_dim, dtype=dtype)
        self.unet = (
            UNet(c_dim, in_channels=c_dim, depth=unet_depth, start_filts=unet_start_filts,
                 dtype=dtype)
            if use_unet else None
        )

    def forward(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        reso = self.reso
        index = {
            plane: coordinate2index(normalize_coordinate(p, self.padding, plane), reso)
            for plane in self.plane_type
        }
        net = self.blocks[0](self.fc_pos(p))
        for block in self.blocks[1:]:
            pooled = 0
            for plane in self.plane_type:
                pooled = pooled + pool_and_gather(net, index[plane], reso * reso, self.scatter_type)
            net = block(torch.cat([net, pooled], dim=-1))
        c = self.fc_c(net)
        planes = [scatter_to_plane(c, index[pl], reso, reduce="mean") for pl in self.plane_type]
        if self.unet is not None:
            B = p.shape[0]
            smoothed = self.unet(torch.cat(planes, dim=0))
            planes = [smoothed[i * B:(i + 1) * B] for i in range(len(planes))]
        return dict(zip(self.plane_type, planes))


class FeaturePlaneMerger(nn.Module):
    """Merge triplane dicts of successive encodes: alpha*new + (1-alpha)*old
    ('average'; the learned 1x1-conv merger is not ported). The weights are
    tensors of the planes' dtype, as JAX rounds its weak-typed floats."""

    def __init__(self, strategy: str = "average", alpha: float = 0.5):
        super().__init__()
        if strategy != "average":
            raise NotImplementedError(f"plane merger strategy {strategy!r}")
        self.alpha = float(alpha)

    def forward(self, plane_1: Dict[str, torch.Tensor], plane_2: Dict[str, torch.Tensor]):
        def weight(w, like):
            return torch.tensor(w, dtype=like.dtype, device=like.device)

        return {k: weight(self.alpha, plane_1[k]) * plane_1[k]
                + weight(1 - self.alpha, plane_2[k]) * plane_2[k] for k in plane_1}
