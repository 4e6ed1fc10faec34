"""torchvision-topology ResNet stages (counterpart of gennerf_tpu/models/resnet.py).

The stem (7x7/2 conv, BatchNorm, ReLU) and the first residual stages of
resnet18/34/50, returning every stage's output. Parameter names are
torchvision's (`conv1`, `bn1`, `layer{s}.{b}.conv1`, `downsample.0/1`), so a
torchvision state dict's stem and stages load directly (its
`num_batches_tracked` entries are dropped); no torchvision is imported.

BatchNorm follows flax's `nn.BatchNorm`, not torch's: in training mode it
normalizes with the batch statistics and moves its running statistics by
ra = 0.9 * ra + 0.1 * batch with the *biased* variance (torch moves them
with the unbiased one). `forward(x, update_stats=False)` normalizes the
same way but leaves the running statistics alone: a checkpointed region's
recompute in backward passes it, so a step updates them once, as flax's
`nn.remat` with `mutable=['batch_stats']` does.

Convolutions start from flax's default (lecun_normal: a normal truncated at
two standard deviations, variance 1/fan_in), BatchNorm from scale 1, bias 0.
"""
from __future__ import annotations

import math
from typing import List

import torch
from torch import nn
import torch.nn.functional as F

# flax's truncated_normal keeps the variance: its stddev is divided by the
# standard deviation of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor) -> torch.Tensor:
    """flax's lecun_normal for a conv or dense weight (fan_in = every axis but the first)."""
    fan_in = weight[0].numel()
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(weight, std=std, a=-2.0 * std, b=2.0 * std)


def conv2d(in_ch: int, out_ch: int, kernel: int, stride: int = 1, padding: int = 0,
           bias: bool = False) -> nn.Conv2d:
    conv = nn.Conv2d(in_ch, out_ch, kernel, stride, padding, bias=bias)
    lecun_normal_(conv.weight)
    if bias:
        nn.init.zeros_(conv.bias)
    return conv


class BatchNorm2d(nn.Module):
    """flax-semantics BatchNorm over (B, C, H, W) (see the module docstring)."""

    def __init__(self, channels: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, update_stats: bool = True) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, self.eps)
        if update_stats:
            with torch.no_grad():
                var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
                self.running_mean.mul_(self.momentum).add_(mean, alpha=1 - self.momentum)
                self.running_var.mul_(self.momentum).add_(var, alpha=1 - self.momentum)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        state_dict.pop(prefix + "num_batches_tracked", None)  # torchvision's counter
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = conv2d(inplanes, planes, 3, stride, 1)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = conv2d(planes, planes, 3, 1, 1)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = (nn.ModuleList([conv2d(inplanes, planes, 1, stride), BatchNorm2d(planes)])
                           if downsample else None)

    def forward(self, x: torch.Tensor, update_stats: bool = True) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x), update_stats))
        out = self.bn2(self.conv2(out), update_stats)
        identity = x if self.downsample is None else self.downsample[1](
            self.downsample[0](x), update_stats)
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = conv2d(inplanes, planes, 1)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = conv2d(planes, planes, 3, stride, 1)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = conv2d(planes, planes * 4, 1)
        self.bn3 = BatchNorm2d(planes * 4)
        self.downsample = (nn.ModuleList([conv2d(inplanes, planes * 4, 1, stride),
                                          BatchNorm2d(planes * 4)]) if downsample else None)

    def forward(self, x: torch.Tensor, update_stats: bool = True) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x), update_stats))
        out = F.relu(self.bn2(self.conv2(out), update_stats))
        out = self.bn3(self.conv3(out), update_stats)
        identity = x if self.downsample is None else self.downsample[1](
            self.downsample[0](x), update_stats)
        return F.relu(out + identity)


RESNET_SPECS = {
    "resnet18": (BasicBlock, (2, 2, 2, 2)),
    "resnet34": (BasicBlock, (3, 4, 6, 3)),
    "resnet50": (Bottleneck, (3, 4, 6, 3)),
}


class ResNetStages(nn.Module):
    """The stem and the first `num_stages` residual stages; forward returns
    [stem, stage1, ..., stage_num_stages] (B, C, H, W) maps."""

    def __init__(self, backbone: str = "resnet34", num_stages: int = 4,
                 use_first_pool: bool = True):
        super().__init__()
        block_cls, layer_counts = RESNET_SPECS[backbone]
        self.use_first_pool = use_first_pool
        self.conv1 = conv2d(3, 64, 7, 2, 3)
        self.bn1 = BatchNorm2d(64)
        self.stages = []
        inplanes, planes = 64, 64
        for stage in range(num_stages):
            blocks = nn.ModuleList()
            for b in range(layer_counts[stage]):
                stride = (1 if stage == 0 else 2) if b == 0 else 1
                out = planes * block_cls.expansion
                blocks.append(block_cls(inplanes, planes, stride,
                                        downsample=b == 0 and (stride != 1 or inplanes != out)))
                inplanes = out
            setattr(self, f"layer{stage + 1}", blocks)
            self.stages.append(f"layer{stage + 1}")
            planes *= 2

    def forward(self, x: torch.Tensor, update_stats: bool = True) -> List[torch.Tensor]:
        x = F.relu(self.bn1(self.conv1(x), update_stats))
        feats = [x]
        for i, name in enumerate(self.stages):
            if i == 0 and self.use_first_pool:
                x = F.max_pool2d(x, 3, 2, 1)
            for block in getattr(self, name):
                x = block(x, update_stats)
            feats.append(x)
        return feats
