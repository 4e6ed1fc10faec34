"""The 2D teacher of semantic distillation (counterpart of
gennerf_tpu/models/teacher.py).

A teacher maps images (B, 3, H, W) to pixel-aligned features (B, C, H',
W'). `RandomProjectionTeacher` is the reference's weight-free stand-in for
a VLM backbone: a frozen convolution with seeded random filters (patch
`patch`, stride `stride`, "SAME" padding as XLA pads it) and a tanh. Its
filters come from `np.random.default_rng(seed)` as in the reference, so
both packages hold the same filters; they are a non-persistent buffer,
outside `state_dict`, as the reference teacher has no params.
`sample_teacher_features` reads the features at image pixels bilinearly.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.interpolation import grid_sample_2d
from .config import TeacherConfig


def same_padding(size: int, kernel: int, stride: int):
    """XLA's "SAME" padding of one axis: (low, high), the odd pixel high."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class RandomProjectionTeacher(nn.Module):
    """Frozen seeded patch projection: conv (stride `stride`, "SAME") with
    (feature_dim, 3, patch, patch) N(0, 1) / sqrt(3 patch^2) filters, then
    tanh(x / 8)."""

    def __init__(self, feature_dim: int = 64, patch: int = 8, stride: int = 4, seed: int = 0):
        super().__init__()
        self.feature_dim, self.patch, self.stride = feature_dim, patch, stride
        w = np.random.default_rng(seed).standard_normal(
            (feature_dim, 3, patch, patch)).astype(np.float32)
        w /= np.sqrt(3 * patch * patch)
        self.register_buffer("filters", torch.from_numpy(w), persistent=False)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) float32 -> (B, C, ceil(H / stride), ceil(W / stride))."""
        H, W = images.shape[-2:]
        ph = same_padding(H, self.patch, self.stride)
        pw = same_padding(W, self.patch, self.stride)
        x = F.pad(images, (pw[0], pw[1], ph[0], ph[1]))
        return torch.tanh(F.conv2d(x, self.filters, stride=self.stride) / 8.0)


def sample_teacher_features(feat_map: torch.Tensor, h_idxs: torch.Tensor, w_idxs: torch.Tensor,
                            image_hw) -> torch.Tensor:
    """Teacher features (B, C, H', W') read bilinearly (corners aligned
    with the image's) at (B, R) pixels of the (H, W) image -> (B, R, C)."""
    H, W = image_hw
    gx = 2.0 * w_idxs.to(torch.float32) / (W - 1) - 1.0
    gy = 2.0 * h_idxs.to(torch.float32) / (H - 1) - 1.0
    grid = torch.stack([gx, gy], dim=-1)[:, :, None, :]
    return grid_sample_2d(feat_map, grid)[..., 0].transpose(1, 2)


def make_teacher(cfg: TeacherConfig) -> Optional[RandomProjectionTeacher]:
    """The config's teacher; None for type 'none'."""
    if cfg.type in (None, "none"):
        return None
    if cfg.type == "random_projection":
        return RandomProjectionTeacher(cfg.feature_dim, cfg.patch, cfg.stride, cfg.seed)
    raise NotImplementedError(f"teacher type {cfg.type!r}")
