"""Segment reductions onto plane cells (counterpart of gennerf_tpu/ops/scatter.py).

Sums accumulate in float32 and return the input dtype; empty segments are 0
(torch_scatter's `scatter_mean(out=zeros)` convention, and the masked
identity of the reference's segment max).
"""
from __future__ import annotations

import torch


def _expand_index(index: torch.Tensor, C: int) -> torch.Tensor:
    return index[..., None].expand(*index.shape, C)


def segment_sum(values: torch.Tensor, index: torch.Tensor, num_segments: int) -> torch.Tensor:
    """(B, N, C) values, (B, N) segment ids -> (B, num_segments, C)."""
    B, _, C = values.shape
    acc = torch.zeros(B, num_segments, C, dtype=torch.float32, device=values.device)
    acc.scatter_add_(1, _expand_index(index, C), values.to(torch.float32))
    return acc.to(values.dtype)


def segment_count(index: torch.Tensor, num_segments: int) -> torch.Tensor:
    """(B, N) -> (B, num_segments) float32 occupancy counts."""
    ones = torch.ones(*index.shape, 1, dtype=torch.float32, device=index.device)
    return segment_sum(ones, index, num_segments)[..., 0]


def segment_mean(values: torch.Tensor, index: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Segment mean; empty segments are 0."""
    total = segment_sum(values, index, num_segments)
    count = segment_count(index, num_segments)
    return total / count.clamp(min=1.0)[..., None]


def segment_max(values: torch.Tensor, index: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Segment max; empty segments are 0.

    The reduction starts from -inf, not 0: scatter_reduce's backward
    splits a segment's gradient evenly among the values equal to its max
    and counts the initial value among them even with include_self=False,
    so a zero start would give ties at 0 (ReLU zeros) 1/(n+1) each where
    the reference's scatter-max gives 1/n. Including a -inf start changes
    no max and saves the kernel that excludes it."""
    B, _, C = values.shape
    out = torch.full((B, num_segments, C), float("-inf"), dtype=values.dtype, device=values.device)
    out = out.scatter_reduce_(1, _expand_index(index, C), values, "amax", include_self=True)
    return out.nan_to_num(neginf=0.0)


def scatter_to_plane(features: torch.Tensor, index: torch.Tensor, reso: int,
                     reduce: str = "mean") -> torch.Tensor:
    """(B, N, C) point features -> (B, C, reso, reso) plane; the flat cell
    index x0 + reso*x1 makes x1 the row axis and x0 the column axis."""
    if reduce == "mean":
        plane = segment_mean(features, index, reso * reso)
    elif reduce == "max":
        plane = segment_max(features, index, reso * reso)
    elif reduce == "sum":
        plane = segment_sum(features, index, reso * reso)
    else:
        raise ValueError(reduce)
    B, _, C = features.shape
    return plane.reshape(B, reso, reso, C).permute(0, 3, 1, 2)


def pool_and_gather(features: torch.Tensor, index: torch.Tensor, num_segments: int,
                    reduce: str = "max") -> torch.Tensor:
    """Local pooling: reduce per segment, gather back to (B, N, C) points."""
    if reduce == "max":
        pooled = segment_max(features, index, num_segments)
    elif reduce == "mean":
        pooled = segment_mean(features, index, num_segments)
    else:
        raise ValueError(reduce)
    return torch.gather(pooled, 1, _expand_index(index, features.shape[-1]))
