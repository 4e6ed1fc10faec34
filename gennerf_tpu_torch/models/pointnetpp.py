"""PointNet++ set-abstraction encoder (counterpart of
gennerf_tpu/models/pointnetpp.py). An orphan module in the reference and
in the JAX package alike: no config builds it.

Three set-abstraction levels: farthest-point centroids (the FPS kernel on
the card; npoint 128 on the input cloud, then 32 on the first level's
centroids), a fixed-size ball query (the first `nsample` points within the
radius in index order, empty slots repeating the first), per-group
Dense + ReLU layers and a max over the group; the last level groups the
whole cloud. Module names: sa{k}.mlp.{i} (flax: sa{k}/mlp_{i}).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.sampling import farthest_point_sample


def square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """(B, N, 3), (B, M, 3) -> (B, N, M) squared distances, as
    |src|^2 + |dst|^2 - 2 src.dst."""
    return ((src ** 2).sum(-1)[..., None] + (dst ** 2).sum(-1)[:, None]
            - 2 * torch.einsum("bnc,bmc->bnm", src, dst))


def query_ball_point(radius: float, nsample: int, xyz: torch.Tensor,
                     new_xyz: torch.Tensor) -> torch.Tensor:
    """(B, S, nsample) int64 indices of the first `nsample` points of
    (B, N, 3) within `radius` of each of (B, S, 3) centroids, in index
    order (a stable sort, as jnp.argsort); slots past the in-ball points
    repeat the first pick."""
    N = xyz.shape[1]
    in_ball = square_distance(new_xyz, xyz) <= radius ** 2
    order = torch.where(in_ball, torch.arange(N, device=xyz.device), N)
    idx = torch.argsort(order, dim=-1, stable=True)[..., :nsample]
    picked_in = torch.gather(order, -1, idx) < N
    return torch.where(picked_in, idx, idx[..., :1])


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) gathered at (B, ...) indices -> (B, ..., C)."""
    B, C = points.shape[0], points.shape[-1]
    flat = idx.reshape(B, -1, 1).expand(-1, -1, C)
    return torch.gather(points, 1, flat).reshape(*idx.shape, C)


class PointNetSetAbstraction(nn.Module):
    def __init__(self, npoint: int, radius: float, nsample: int, in_channel: int,
                 mlp: Sequence[int], group_all: bool = False):
        super().__init__()
        self.npoint, self.radius, self.nsample, self.group_all = npoint, radius, nsample, group_all
        widths = [in_channel, *mlp]
        self.mlp = nn.ModuleList(nn.Linear(a, b) for a, b in zip(widths[:-1], widths[1:]))

    def forward(self, xyz: torch.Tensor, points: Optional[torch.Tensor],
                generator: Optional[torch.Generator] = None,
                start: Optional[torch.Tensor] = None):
        """(B, N, 3) points and optional (B, N, C) features -> new_xyz
        (B, npoint, 3) and new_points (B, npoint, mlp[-1]); `start` (B,)
        injects the FPS start draw."""
        if self.group_all:
            new_xyz = torch.zeros(xyz.shape[0], 1, 3, dtype=xyz.dtype, device=xyz.device)
            grouped = xyz[:, None]
            if points is not None:
                grouped = torch.cat([grouped, points[:, None]], dim=-1)
        else:
            new_xyz, _ = farthest_point_sample(xyz, self.npoint, generator, start)
            idx = query_ball_point(self.radius, self.nsample, xyz, new_xyz)
            grouped = index_points(xyz, idx) - new_xyz[:, :, None]
            if points is not None:
                grouped = torch.cat([grouped, index_points(points, idx)], dim=-1)
        h = grouped
        for layer in self.mlp:
            h = torch.relu(layer(h))
        return new_xyz, h.amax(dim=2)


class PointNetPlusPlus(nn.Module):
    """(B, N, 3) cloud -> (B, feature_dim) global feature."""

    def __init__(self, feature_dim: int = 256):
        super().__init__()
        self.sa1 = PointNetSetAbstraction(128, 0.2, 32, 3, (64, 64, 128))
        self.sa2 = PointNetSetAbstraction(32, 0.4, 32, 3 + 128, (128, 128, 256))
        self.sa3 = PointNetSetAbstraction(1, 1.0, 1, 3 + 256, (256, 256, feature_dim),
                                          group_all=True)

    def forward(self, xyz: torch.Tensor, generator: Optional[torch.Generator] = None,
                starts: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """`starts`: the two SA levels' injected (B,) FPS starts."""
        s1, s2 = starts if starts is not None else (None, None)
        l1_xyz, l1_pts = self.sa1(xyz, None, generator, s1)
        l2_xyz, l2_pts = self.sa2(l1_xyz, l1_pts, generator, s2)
        _, l3_pts = self.sa3(l2_xyz, l2_pts)
        return l3_pts[:, 0]
