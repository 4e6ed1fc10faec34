"""TSDF heads (counterpart of gennerf_tpu/models/heads.py): the point-wise
TSDFHeadSimple of GenNerf (parameter name head_geo.fc as in the reference
checkpoint) and VoxelNet's multi-scale volumetric TSDFHead / VoxelHeads."""
from __future__ import annotations

import warnings
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.value_transforms import log_transform
from ..parallel.distributed import global_ratio
from .resnet import conv3d
from .resnetfc import linear


class TSDFHeadSimple(nn.Module):
    """Linear -> tanh, scaled by `smoothing` after the tanh (1.0 leaves the
    reference head math unchanged). Under a compute `dtype` the layer runs
    in it (flax's Dense with dtype=), so the TSDF comes out in it, and the
    smoothing constant is a tensor of that dtype, as JAX rounds a
    weak-typed float to the array's dtype."""

    def __init__(self, d_in: int, smoothing: float = 1.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc = linear(d_in, 1, dtype=dtype)
        nn.init.xavier_uniform_(self.fc.weight, gain=5.0 / 3.0)
        nn.init.zeros_(self.fc.bias)
        self.smoothing = float(smoothing)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.tanh(self.fc(x))
        if self.smoothing == 1.0:
            return y
        return y * torch.tensor(self.smoothing, dtype=y.dtype, device=y.device)


def upsample2x_nearest3d(x: torch.Tensor) -> torch.Tensor:
    """(B, C, nx, ny, nz) -> 2x nearest upsampling (every voxel repeated
    twice along each axis)."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3).repeat_interleave(2, dim=4)


class TSDFHead(nn.Module):
    """Multi-scale volumetric TSDF head with coarse-to-fine sparsification
    (counterpart of gennerf_tpu/models/heads.py TSDFHead).

    Scales run coarse first: `xs` are the backbone's up-path volumes
    coarse -> fine and `voxel_sizes` [final * 2^i] reversed (e.g. [8, 4]).
    Each scale is a bias-free 1x1x1 convolution (`decoders.{i}`, the
    reference's names) in the compute dtype, tanh, times label_smoothing;
    the constant is a tensor of the compute dtype, as JAX multiplies a
    bf16 tanh by the weak-typed 1.05 (1.046875 in bf16). Under loss_split
    'pred' a finer scale keeps its value where the upsampled coarser
    prediction lies inside the sparse threshold, and the coarse sign times
    0.999 elsewhere; every other value computes 'none', as the JAX head
    tests `== "pred"` only, and a value other than 'none' warns. Outputs
    and losses are float32."""

    def __init__(self, channels: Sequence[int], voxel_size: float, multi_scale: bool = True,
                 loss_weight: float = 1.0, label_smoothing: float = 1.05,
                 loss_split: str = "pred", loss_log_transform: bool = True,
                 loss_log_transform_shift: float = 1.0,
                 sparse_threshold: Sequence[float] = (0.99, 0.99, 0.99),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if loss_split not in ("pred", "none"):
            warnings.warn(f"heads.tsdf_loss_split {loss_split!r} computes 'none': the JAX "
                          f"package's TSDF head splits only under 'pred'")
        self.multi_scale, self.loss_weight = multi_scale, loss_weight
        self.label_smoothing, self.loss_split = label_smoothing, loss_split
        self.log_transform, self.shift = loss_log_transform, loss_log_transform_shift
        self.sparse_threshold, self.dtype = tuple(sparse_threshold), dtype
        final = int(voxel_size * 100)
        scales = len(channels) - 1
        self.voxel_sizes = ([final * 2 ** i for i in range(scales)][::-1] if multi_scale
                            else [final])
        widths = list(channels[:-1])[::-1] if multi_scale else [channels[0]]
        self.decoders = nn.ModuleList(conv3d(c, 1, 1, dtype=dtype) for c in widths)

    def forward(self, xs: Sequence[torch.Tensor],
                targets: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        if not self.multi_scale:
            xs = xs[-1:]
        dt = self.dtype
        smoothing = torch.tensor(self.label_smoothing, dtype=dt, device=xs[0].device)
        output: Dict[str, torch.Tensor] = {}
        surface = []
        for i, x in enumerate(xs):
            tsdf = torch.tanh(self.decoders[i](x)) * smoothing
            if self.loss_split == "pred" and i > 0:
                prev_up = upsample2x_nearest3d(output["vol_%02d_tsdf" % self.voxel_sizes[i - 1]])
                mask_prev = prev_up.abs() < self.sparse_threshold[i - 1]
                tsdf = torch.where(mask_prev, tsdf, torch.sign(prev_up) * 0.999)
                surface.append(mask_prev)
            output["vol_%02d_tsdf" % self.voxel_sizes[i]] = tsdf.to(torch.float32)

        losses: Dict[str, torch.Tensor] = {}
        for i, vs in enumerate(self.voxel_sizes if targets is not None else ()):
            key = "vol_%02d_tsdf" % vs
            if key not in targets:  # partial supervision: skip absent scales
                continue
            pred, trgt = output[key], targets[key].to(torch.float32)
            wanted = (trgt < 1) | (trgt == 1).all(dim=-1, keepdim=True)
            if self.log_transform:
                pred, trgt = log_transform(pred, self.shift), log_transform(trgt, self.shift)
            loss = (pred - trgt).abs() * self.loss_weight
            if self.loss_split == "pred" and i > 0:
                wanted = wanted & surface[i - 1]
            losses[key + "_loss"] = global_ratio(
                torch.where(wanted, loss, torch.zeros_like(loss)).sum(), wanted.sum())
        return output, losses


class VoxelHeads(nn.Module):
    """The volumetric heads (the reference's `heads.0` is the TSDF head;
    its semantic and colour heads are disabled there and not ported)."""

    def __init__(self, channels: Sequence[int], voxel_size: float, tsdf_multi_scale: bool = True,
                 tsdf_loss_weight: float = 1.0, tsdf_label_smoothing: float = 1.05,
                 tsdf_loss_split: str = "pred", tsdf_loss_log_transform: bool = True,
                 tsdf_loss_log_transform_shift: float = 1.0,
                 tsdf_sparse_threshold: Sequence[float] = (0.99, 0.99, 0.99),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads = nn.ModuleList([TSDFHead(
            channels, voxel_size, tsdf_multi_scale, tsdf_loss_weight, tsdf_label_smoothing,
            tsdf_loss_split, tsdf_loss_log_transform, tsdf_loss_log_transform_shift,
            tsdf_sparse_threshold, dtype)])

    def forward(self, xs, targets=None):
        return self.heads[0](xs, targets)
