"""3D U-Net smoothing the pointnet's feature grid (counterpart of
gennerf_tpu/models/unet3d.py, itself a compact port of the reference's
pytorch-3dunet module).

Channels-first (B, C, X, Y, Z) throughout. Per level a double conv (two
3x3x3 convs without bias, each followed by flax's GroupNorm and a ReLU),
`f_maps * 2**level` channels; 2x2x2 max-pool downs (odd sizes floor);
nearest x2 repeats up, cropped to the skip's shape and concatenated before
it; a final 1x1x1 conv with bias. Module names: enc.{level}.conv_{k} /
norm_{k}, dec.{level}.conv_{k} / norm_{k}, final (flax: enc_{level},
dec_{level} with Conv_k / GroupNorm_k, final). Float32 only.
"""
from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from .resnet import Conv3d, cast_conv


def group_count(channels: int, num_groups: int = 8) -> int:
    """The JAX module's group count: min(num_groups, channels), lowered
    until it divides the channels."""
    groups = min(num_groups, channels)
    while channels % groups:
        groups -= 1
    return groups


class GroupNorm(nn.Module):
    """flax's nn.GroupNorm on channels-first tensors: epsilon 1e-6, each
    group's statistics over its channels and every spatial position, the
    variance as E[x^2] - E[x]^2 clipped at 0, then (x - mean) *
    (rsqrt(var + eps) * weight) + bias."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-6):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C = x.shape[:2]
        per_group, shape = C // self.num_groups, (1,) * (x.dim() - 2)
        g = x.reshape(B, self.num_groups, -1)
        mean = g.mean(-1)
        var = torch.clamp_min((g * g).mean(-1) - mean * mean, 0.0)

        def per_channel(t):
            return t.repeat_interleave(per_group, 1).reshape(B, C, *shape)

        mul = per_channel(torch.rsqrt(var + self.eps)) * self.weight.reshape(1, C, *shape)
        return (x - per_channel(mean)) * mul + self.bias.reshape(1, C, *shape)


class DoubleConv3d(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, num_groups: int = 8):
        super().__init__()
        groups = group_count(out_channels, num_groups)
        for k, ins in enumerate((in_channels, out_channels)):
            self.add_module(f"conv_{k}", cast_conv(Conv3d, ins, out_channels, 3, padding=1,
                                                   bias=False))
            self.add_module(f"norm_{k}", GroupNorm(groups, out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for k in range(2):
            x = F.relu(getattr(self, f"norm_{k}")(getattr(self, f"conv_{k}")(x)))
        return x


class UNet3D(nn.Module):
    """(B, in_channels, X, Y, Z) -> (B, out_channels, X, Y, Z)."""

    def __init__(self, in_channels: int, out_channels: int, f_maps: int = 32,
                 num_levels: int = 3):
        super().__init__()
        widths = [f_maps * 2 ** level for level in range(num_levels)]
        self.enc = nn.ModuleList()
        ins = in_channels
        for w in widths:
            self.enc.append(DoubleConv3d(ins, w))
            ins = w
        # dec[level] merges the level's skip; the coarsest level has none
        self.dec = nn.ModuleList(DoubleConv3d(widths[level + 1] + widths[level], widths[level])
                                 for level in range(num_levels - 1))
        self.final = cast_conv(Conv3d, widths[0], out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skips = []
        for level, enc in enumerate(self.enc):
            x = enc(x)
            if level < len(self.enc) - 1:
                skips.append(x)
                x = F.max_pool3d(x, 2, 2)
        for level in reversed(range(len(self.dec))):
            skip = skips[level]
            x = x.repeat_interleave(2, 2).repeat_interleave(2, 3).repeat_interleave(2, 4)
            x = x[:, :, :skip.shape[2], :skip.shape[3], :skip.shape[4]]
            x = self.dec[level](torch.cat([x, skip], dim=1))
        return self.final(x)
