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

Norms: 'BN' / 'nnSyncBN' (one card: the same) are flax-semantics
BatchNorm, 'GN' flax's GroupNorm with min(32, C) groups (epsilon 1e-6, the
zero-init scales kept), '' none. Dropout (`drop` > 0, training mode only)
sits where the JAX module's does: after both norms of every residual
block and after each down stage's norm (the reference Sequential's slot 2),
with flax's semantics: keep with probability 1 - p, kept values scaled by
1 / (1 - p). Its keep masks come from a `DropoutDraws`, in the JAX call
order, injected or drawn from a generator; each block's masks are drawn
before its checkpoint region and passed in, so a recompute in backward
reuses them, as JAX's remat replays its key (torch.utils.checkpoint
replays the global RNG only, not an explicit generator).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn
import torch.nn.functional as F

from ..ops.sampling import draw_uniform
from .gen_nerf import _remat
from .resnet import BatchNorm, conv3d
from .unet3d import GroupNorm


def norm3d(norm: str, channels: int, zero_init: bool = False,
           dtype: torch.dtype = torch.float32) -> nn.Module:
    """'BN' / 'nnSyncBN' (one card: the same) -> a float32-returning
    BatchNorm; 'GN' -> flax's GroupNorm over min(32, channels) groups
    (float32 out); '' -> identity."""
    if norm in ("BN", "nnSyncBN"):
        return BatchNorm(channels, dtype=dtype, float_output=True, zero_init=zero_init)
    if norm == "GN":
        return GroupNorm(min(32, channels), channels, zero_init=zero_init)
    if norm == "":
        return _NoNorm()
    raise NotImplementedError(f"backbone3d.norm {norm!r}")


class DropoutDraws:
    """The keep masks of one forward's dropout sites at rate `p`, taken in
    the JAX module's call order: `masks` injected (bool, channels-first,
    one per site), else drawn from `generator` (uniform < 1 - p, as
    jax.random.bernoulli; None: the global generator)."""

    def __init__(self, p: float, masks: Optional[Sequence[torch.Tensor]] = None,
                 generator: Optional[torch.Generator] = None):
        self.p, self.generator = float(p), generator
        self.masks = None if masks is None else list(masks)
        self.taken = 0

    def next(self, shape, device) -> torch.Tensor:
        if self.masks is None:
            return draw_uniform(tuple(shape), self.generator, device) < 1.0 - self.p
        if self.taken >= len(self.masks):
            raise ValueError(f"{len(self.masks)} dropout masks injected, the forward needs more")
        mask = self.masks[self.taken].to(device=device, dtype=torch.bool)
        self.taken += 1
        if tuple(mask.shape) != tuple(shape):
            raise ValueError(f"dropout mask {self.taken - 1} has shape {tuple(mask.shape)}, "
                             f"the site {tuple(shape)}")
        return mask


def dropout(x: torch.Tensor, mask: Optional[torch.Tensor], p: float) -> torch.Tensor:
    """flax's nn.Dropout in training: x / (1 - p) where `mask`, else 0;
    None (eval mode, or no dropout) leaves x as it is."""
    if mask is None:
        return x
    return torch.where(mask, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))


class _NoNorm(nn.Module):
    def forward(self, x: torch.Tensor, update_stats: bool = True) -> torch.Tensor:
        return x


class BasicBlock3d(nn.Module):
    """3x3x3 residual block; `downsample` is a 1x1x1 convolution where the
    stride or the width changes."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, norm: str = "BN",
                 dtype: torch.dtype = torch.float32, drop: float = 0.0):
        super().__init__()
        self.drop = drop
        self.conv1 = conv3d(inplanes, planes, 3, stride, 1, dtype=dtype)
        self.bn1 = norm3d(norm, planes, dtype=dtype)
        self.conv2 = conv3d(planes, planes, 3, 1, 1, dtype=dtype)
        self.bn2 = norm3d(norm, planes, zero_init=True, dtype=dtype)
        self.downsample = (conv3d(inplanes, planes, 1, stride, dtype=dtype)
                           if stride != 1 or inplanes != planes else None)

    def forward(self, x: torch.Tensor, mask1: Optional[torch.Tensor] = None,
                mask2: Optional[torch.Tensor] = None, update_stats: bool = True) -> torch.Tensor:
        """`mask1` / `mask2`: the keep masks of the dropouts after bn1 and
        bn2 (None: no dropout)."""
        out = F.relu(dropout(self.bn1(self.conv1(x), update_stats), mask1, self.drop))
        out = dropout(self.bn2(self.conv2(out), update_stats), mask2, self.drop)
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
                 dtype: torch.dtype = torch.float32, drop: float = 0.0):
        super().__init__()
        channels = list(channels)
        self.cond_proj, self.remat, self.drop = cond_proj, remat, float(drop)

        def block(width):
            return BasicBlock3d(width, width, norm=norm, dtype=dtype, drop=self.drop)

        self.layers_down = nn.ModuleList()
        self.layers_down.append(nn.ModuleList(block(channels[0])
                                              for _ in range(layers_down[0])))
        for i in range(1, len(channels)):
            # the reference's Sequential: conv, norm, dropout (its slot holds
            # no parameters; forward applies the mask), ReLU, blocks
            stage = [conv3d(channels[i - 1], channels[i], 3, 2, 1, bias=norm == "", dtype=dtype),
                     norm3d(norm, channels[i], dtype=dtype), nn.Identity(), nn.ReLU()]
            stage += [block(channels[i]) for _ in range(layers_down[i])]
            self.layers_down.append(nn.ModuleList(stage))
        rev = channels[::-1]
        self.layers_up_conv = nn.ModuleList(conv3d(rev[i], rev[i + 1], 1, dtype=dtype)
                                            for i in range(len(rev) - 1))
        self.proj = nn.ModuleList(ConditionalProjection(rev[i + 1], rev[i + 1], norm, cond_proj,
                                                        dtype) for i in range(len(rev) - 1))
        self.layers_up_res = nn.ModuleList(
            nn.ModuleList(block(rev[i + 1]) for _ in range(layers_up[i]))
            for i in range(len(rev) - 1))

    def _mask(self, draws: Optional[DropoutDraws], x: torch.Tensor, channels: int):
        """The next site's keep mask for an output of `channels` at x's
        size, or None when no dropout runs (eval mode, p 0)."""
        if not (self.training and self.drop > 0):
            return None
        return draws.next((x.shape[0], channels) + tuple(x.shape[2:]), x.device)

    def _block(self, block: nn.Module, x: torch.Tensor,
               draws: Optional[DropoutDraws]) -> torch.Tensor:
        width = block.conv1.out_channels  # every block has stride 1
        masks = (self._mask(draws, x, width), self._mask(draws, x, width))
        if self.remat and torch.is_grad_enabled():
            return _remat(block, x, *masks)
        return block(x, *masks)

    def forward(self, x: torch.Tensor, draws: Optional[DropoutDraws] = None
                ) -> List[torch.Tensor]:
        """`draws`: the dropout masks (training mode with drop > 0; None
        draws them from the global generator)."""
        if self.training and self.drop > 0 and draws is None:
            draws = DropoutDraws(self.drop)
        if self.cond_proj:
            valid_mask = (x != 0).any(dim=1, keepdim=True)
        xs = []
        for block in self.layers_down[0]:
            x = self._block(block, x, draws)
        xs.append(x)
        for stage in self.layers_down[1:]:
            x = stage[1](stage[0](x))
            x = stage[3](dropout(x, self._mask(draws, x, x.shape[1]), self.drop))
            for block in stage[4:]:
                x = self._block(block, x, draws)
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
                x = self._block(block, x, draws)
            out.append(x)
        return out
