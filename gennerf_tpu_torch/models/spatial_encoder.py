"""Pixel-aligned 2D image encoder (counterpart of gennerf_tpu/models/spatial_encoder.py).

An optional Gaussian pre-blur, an optional rescale (`feature_scale` > 1:
align-corners bilinear up; < 1: average pooling down), the ResNet stem and
its first `num_layers - 1` stages, every map resized to the stem's
resolution (align-corners bilinear) and concatenated along channels, and an
optional 1x1 `proj` conv (with bias) to `out_channels`. NCHW throughout.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.coords import linspace
from ..ops.value_transforms import apply_gaussian_smoothing
from .resnet import RESNET_SPECS, ResNetStages, conv2d


def spatial_latent_size(backbone: str, num_layers: int) -> int:
    """Channels of the concatenated [stem, stage1, ..., stage_{num_layers-1}]."""
    block, _ = RESNET_SPECS[backbone]
    widths = [64] + [64 * 2 ** i * block.expansion for i in range(4)]
    return sum(widths[:num_layers])


def _lerp_axis(x: torch.Tensor, dim: int, out_size: int) -> torch.Tensor:
    """Align-corners linear resize of one axis, the source coordinates
    rounded as the reference's compiled jnp.linspace (F.interpolate computes
    them in another order, which moves `floor` at exact texel hits)."""
    size = x.shape[dim]
    src = linspace(0.0, size - 1.0, out_size, x.device)
    i0 = torch.floor(src).to(torch.int64).clamp(0, size - 1)
    i1 = (i0 + 1).clamp(0, size - 1)
    shape = [1] * x.dim()
    shape[dim] = out_size
    w = (src - i0.to(src.dtype)).to(x.dtype).reshape(shape)
    return x.index_select(dim, i0) * (1 - w) + x.index_select(dim, i1) * w


def resize_bilinear_align_corners(x: torch.Tensor, out_hw) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, OH, OW) with align_corners=True: the width
    pass, then the height pass. The values equal the reference's four-tap
    formula term for term: its top row is the width pass at row y0, its
    bottom row the width pass at row y1."""
    OH, OW = (int(s) for s in out_hw)
    if (OH, OW) == tuple(x.shape[-2:]):
        return x
    return _lerp_axis(_lerp_axis(x, 3, OW), 2, OH)


class SpatialEncoder(nn.Module):
    def __init__(self, backbone: str = "resnet34", num_layers: int = 4,
                 feature_scale: float = 1.0, use_first_pool: bool = True,
                 blur_image: bool = False, kernel_size: int = 5, sigma: float = 1.0,
                 out_channels: Optional[int] = None):
        super().__init__()
        self.feature_scale = float(feature_scale)
        self.blur_image, self.kernel_size, self.sigma = blur_image, kernel_size, sigma
        # the stem counts as the first map
        self.resnet = ResNetStages(backbone, num_layers - 1, use_first_pool)
        latent = spatial_latent_size(backbone, num_layers)
        self.proj = conv2d(latent, out_channels, 1, bias=True) if out_channels else None
        self.latent_size = out_channels or latent

    def forward(self, x: torch.Tensor, update_stats: bool = True) -> torch.Tensor:
        """(B, 3, H, W) images -> (B, latent_size, H', W'), H' = H * feature_scale / 2.
        `update_stats`: see models/resnet.py (training mode only)."""
        if self.blur_image:
            x = apply_gaussian_smoothing(x, self.kernel_size, self.sigma)
        if self.feature_scale > 1.0:
            H, W = x.shape[-2:]
            x = resize_bilinear_align_corners(
                x, (int(H * self.feature_scale), int(W * self.feature_scale)))
        elif self.feature_scale < 1.0:
            f = int(round(1.0 / self.feature_scale))
            x = torch.nn.functional.avg_pool2d(x, f, f)
        feats = self.resnet(x, update_stats)
        target = feats[0].shape[-2:]
        latent = torch.cat([resize_bilinear_align_corners(f, target) for f in feats], dim=1)
        return latent if self.proj is None else self.proj(latent)
