"""Normals of an organized point map (counterpart of gennerf_tpu/ops/normals.py).

For each pixel, of the 8 pairs of neighbours 2 pixels away in directions 90
degrees apart, the pair nearest the pixel's point spans the normal (their
cross product, normalized). Points outside the map are NaN; a pixel where
no pair is finite has a NaN normal.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_LOOKUPS = (  # (dy, dx) of the 8 directions around a pixel
    (-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1), (0, -1), (-1, -1),
)


def _norm(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    return torch.sqrt((x * x).sum(-1, keepdim=keepdim))


def estimate_pointcloud_normals(points: torch.Tensor, d: int = 2) -> torch.Tensor:
    """(..., H, W, 3) point maps -> (..., H, W, 3) unit normals, NaN where
    undefined."""
    H, W = points.shape[-3:-1]
    # pad H and W (the last two dims of the channels-first view) with NaN
    padded = F.pad(points.movedim(-1, -3), (d, d, d, d), value=float("nan")).movedim(-3, -1)
    anchor = points

    def shifted(k: int) -> torch.Tensor:
        dy, dx = _LOOKUPS[k]
        return padded[..., d + dy * d:d + dy * d + H, d + dx * d:d + dx * d + W, :]

    p2 = torch.stack([shifted(k) for k in range(8)])  # (8, ..., H, W, 3)
    p3 = torch.stack([shifted((k + 2) % 8) for k in range(8)])
    diff = _norm(p2 - anchor) + _norm(p3 - anchor)  # (8, ..., H, W)
    diff = torch.where(torch.isnan(diff), torch.full_like(diff, float("inf")), diff)
    best = torch.argmin(diff, dim=0, keepdim=True)[..., None]  # (1, ..., H, W, 1)
    sel2 = torch.take_along_dim(p2, best.expand(1, *p2.shape[1:]), dim=0)[0]
    sel3 = torch.take_along_dim(p3, best.expand(1, *p3.shape[1:]), dim=0)[0]
    normals = torch.linalg.cross(sel2 - anchor, sel3 - anchor, dim=-1)
    normals = normals / _norm(normals, keepdim=True)
    undefined = torch.isinf(diff.amin(dim=0))
    return torch.where(undefined[..., None], torch.full_like(normals, float("nan")), normals)
