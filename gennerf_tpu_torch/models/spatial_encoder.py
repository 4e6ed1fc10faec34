"""Pixel-aligned 2D image encoder (counterpart of gennerf_tpu/models/spatial_encoder.py).

An optional Gaussian pre-blur, an optional rescale (`feature_scale` > 1:
align-corners bilinear up; < 1: average pooling down), the ResNet stem and
its first `num_layers - 1` stages, every map resized to the stem's
resolution (align-corners bilinear) and concatenated along channels, and an
optional 1x1 `proj` conv (with bias) to `out_channels`. NCHW throughout.
With an `upsample_interp` other than 'bilinear' the maps are not resized,
as in the JAX encoder: the concatenation then works only where every map
has the stem's size (one layer), and raises ValueError naming the sizes
elsewhere (the JAX concatenate fails there too). `norm_type`: see
models/resnet.ResNetStages.
Under a compute `dtype` (bf16-mixed) the ResNet and `proj` compute in it
and the stage resizes weight in their input's dtype, as the JAX encoder's;
the input image and its rescale stay float32.

With a `proj`, bilinear resizes and the bf16 compute dtype, the resizes,
the concatenation and `proj` of CUDA maps run as one fused operation
(ops/spatial_lift.spatial_lift: the csrc/spatial_lift.cu kernel, whose
latent never reaches device memory, and a reassociated float32 backward);
every other case, the CPU among them, runs them unfused. Counters (while
a profiler records): `lift.pixels`, the output pixels of every call, and
`lift.fused_pixels`, those of the fused calls.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.spatial_lift import resize_bilinear_align_corners, spatial_lift
from ..ops.value_transforms import apply_gaussian_smoothing
from ..utils.spans import count
from .resnet import RESNET_SPECS, ResNetStages, conv2d
from .resnetfc import compute_dtype_of


def spatial_latent_size(backbone: str, num_layers: int) -> int:
    """Channels of the concatenated [stem, stage1, ..., stage_{num_layers-1}]."""
    block, _ = RESNET_SPECS[backbone]
    widths = [64] + [64 * 2 ** i * block.expansion for i in range(4)]
    return sum(widths[:num_layers])


class SpatialEncoder(nn.Module):
    def __init__(self, backbone: str = "resnet34", num_layers: int = 4,
                 feature_scale: float = 1.0, use_first_pool: bool = True,
                 blur_image: bool = False, kernel_size: int = 5, sigma: float = 1.0,
                 out_channels: Optional[int] = None, dtype: torch.dtype = torch.float32,
                 norm_type: str = "batch", upsample_interp: str = "bilinear"):
        super().__init__()
        self.feature_scale = float(feature_scale)
        self.blur_image, self.kernel_size, self.sigma = blur_image, kernel_size, sigma
        self.resize = upsample_interp == "bilinear"
        # the stem counts as the first map
        self.resnet = ResNetStages(backbone, num_layers - 1, use_first_pool, dtype, norm_type)
        latent = spatial_latent_size(backbone, num_layers)
        self.proj = (conv2d(latent, out_channels, 1, bias=True, dtype=dtype)
                     if out_channels else None)
        self.latent_size = out_channels or latent
        # the fused lift's static conditions; the maps' device decides at run time
        self.fused_lift = bool(out_channels) and self.resize and (
            compute_dtype_of(dtype) == torch.bfloat16)

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
        pixels = feats[0].shape[0] * target[0] * target[1]
        count("lift.pixels", pixels)
        if self.fused_lift and feats[0].is_cuda:
            count("lift.fused_pixels", pixels)
            return spatial_lift(feats, self.proj.weight, self.proj.bias)
        if self.resize:
            feats = [resize_bilinear_align_corners(f, target) for f in feats]
        elif any(f.shape[-2:] != target for f in feats):
            raise ValueError(f"spatial.upsample_interp other than 'bilinear' leaves the maps "
                             f"unresized, and their sizes {[tuple(f.shape[-2:]) for f in feats]} "
                             f"differ: only one layer (or maps of one size) can be concatenated")
        latent = torch.cat(feats, dim=1)
        return latent if self.proj is None else self.proj(latent)
