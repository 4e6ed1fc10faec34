"""Atlas-style 3D encoder-decoder that refines the feature volume
(counterpart of gennerf_tpu/models/backbone3d.py).

A down path of strided 3x3x3 convolutions and BasicBlock3d residual stacks,
an up path of trilinear 2x upsamples, 1x1x1 convolutions and projected
(optionally masked) skip connections; every block's second norm starts at
scale 0, so a block starts as the identity. Channels-first (B, C, nx, ny,
nz) throughout (cuDNN's conv3d layout; the JAX modules run channels-last,
which changes no value). Parameter names are the reference's
(`layers_down.{i}`, `proj.{i}`, `layers_up_conv.{i}`, `layers_up_res.{i}`),
so a reference state dict loads directly.

Mixed precision as flax's `dtype=`: convolutions compute in the compute
dtype; the norms compute in float32 and return float32 (`_norm_dtype` of
the JAX module), so the stream between blocks is float32 and every
convolution casts its input again. With `remat` every residual block is a
checkpoint region whose recompute leaves the running statistics alone.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn
import torch.nn.functional as F

from .gen_nerf import _remat
from .resnet import BatchNorm, conv3d


def norm3d(norm: str, channels: int, zero_init: bool = False,
           dtype: torch.dtype = torch.float32) -> nn.Module:
    """'BN' / 'nnSyncBN' (one card: the same) -> a float32-returning
    BatchNorm; '' -> identity ('GN' is rejected by the config gate)."""
    if norm in ("BN", "nnSyncBN"):
        return BatchNorm(channels, dtype=dtype, float_output=True, zero_init=zero_init)
    if norm == "":
        return _NoNorm()
    raise NotImplementedError(f"backbone3d.norm {norm!r}")


class _NoNorm(nn.Module):
    def forward(self, x: torch.Tensor, update_stats: bool = True) -> torch.Tensor:
        return x


class BasicBlock3d(nn.Module):
    """3x3x3 residual block; `downsample` is a 1x1x1 convolution where the
    stride or the width changes."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, norm: str = "BN",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = conv3d(inplanes, planes, 3, stride, 1, dtype=dtype)
        self.bn1 = norm3d(norm, planes, dtype=dtype)
        self.conv2 = conv3d(planes, planes, 3, 1, 1, dtype=dtype)
        self.bn2 = norm3d(norm, planes, zero_init=True, dtype=dtype)
        self.downsample = (conv3d(inplanes, planes, 1, stride, dtype=dtype)
                           if stride != 1 or inplanes != planes else None)

    def forward(self, x: torch.Tensor, update_stats: bool = True) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x), update_stats))
        out = self.bn2(self.conv2(out), update_stats)
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ConditionalProjection(nn.Module):
    """The projected skip: a 1x1x1 convolution of the skip volume, where
    `condition` replaced by the up path's value outside the observed
    voxels, then norm and ReLU."""

    def __init__(self, in_ch: int, n: int, norm: str = "BN", condition: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.condition = condition
        self.conv = conv3d(in_ch, n, 1, dtype=dtype)
        self.norm = norm3d(norm, n, dtype=dtype)

    def forward(self, x, y, mask, update_stats: bool = True):
        x = self.conv(x)
        if self.condition:
            x = torch.where(mask, x, y)
        return F.relu(self.norm(x, update_stats))


def trilinear_up2x(x: torch.Tensor) -> torch.Tensor:
    """(B, C, nx, ny, nz) -> (B, C, 2nx, 2ny, 2nz), trilinear with half-pixel
    centers (jax.image.resize 'trilinear' of the JAX module)."""
    return F.interpolate(x, scale_factor=2, mode="trilinear", align_corners=False)


class EncoderDecoder(nn.Module):
    """forward: (B, channels[0], nx, ny, nz) -> the up path's volumes,
    coarse -> fine, float32 (B, channels[-2-i], ...)."""

    def __init__(self, channels: Sequence[int] = (32, 64, 128),
                 layers_down: Sequence[int] = (1, 2, 3), layers_up: Sequence[int] = (3, 3, 3),
                 norm: str = "BN", cond_proj: bool = True, remat: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        channels = list(channels)
        self.cond_proj, self.remat = cond_proj, remat
        self.layers_down = nn.ModuleList()
        self.layers_down.append(nn.ModuleList(
            BasicBlock3d(channels[0], channels[0], norm=norm, dtype=dtype)
            for _ in range(layers_down[0])))
        for i in range(1, len(channels)):
            # the reference's Sequential: conv, norm, dropout, ReLU, blocks
            stage = [conv3d(channels[i - 1], channels[i], 3, 2, 1, bias=norm == "", dtype=dtype),
                     norm3d(norm, channels[i], dtype=dtype), nn.Identity(), nn.ReLU()]
            stage += [BasicBlock3d(channels[i], channels[i], norm=norm, dtype=dtype)
                      for _ in range(layers_down[i])]
            self.layers_down.append(nn.ModuleList(stage))
        rev = channels[::-1]
        self.layers_up_conv = nn.ModuleList(conv3d(rev[i], rev[i + 1], 1, dtype=dtype)
                                            for i in range(len(rev) - 1))
        self.proj = nn.ModuleList(ConditionalProjection(rev[i + 1], rev[i + 1], norm, cond_proj,
                                                        dtype) for i in range(len(rev) - 1))
        self.layers_up_res = nn.ModuleList(
            nn.ModuleList(BasicBlock3d(rev[i + 1], rev[i + 1], norm=norm, dtype=dtype)
                          for _ in range(layers_up[i])) for i in range(len(rev) - 1))

    def _block(self, block: nn.Module, x: torch.Tensor) -> torch.Tensor:
        if self.remat and torch.is_grad_enabled():
            return _remat(block, x)
        return block(x)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        if self.cond_proj:
            valid_mask = (x != 0).any(dim=1, keepdim=True)
        xs = []
        for block in self.layers_down[0]:
            x = self._block(block, x)
        xs.append(x)
        for stage in self.layers_down[1:]:
            x = stage[3](stage[2](stage[1](stage[0](x))))
            for block in stage[4:]:
                x = self._block(block, x)
            xs.append(x)

        xs = xs[::-1]
        n_up = len(self.layers_up_conv)
        out = []
        for i in range(n_up):
            x = self.layers_up_conv[i](trilinear_up2x(x))
            mask = None
            if self.cond_proj:
                scale = 2 ** (n_up - i - 1)
                m = valid_mask[:, :, ::scale, ::scale, ::scale]  # nearest downsample
                mask = m[:, :, :x.shape[2], :x.shape[3], :x.shape[4]]
            y = self.proj[i](xs[i + 1], x, mask)
            x = (x + y) / 2
            for block in self.layers_up_res[i]:
                x = self._block(block, x)
            out.append(x)
        return out
