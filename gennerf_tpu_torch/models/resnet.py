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

Mixed precision follows flax's `dtype=`: every module takes a compute
`dtype`; a convolution casts its input and weight to it (a bias is added
after the convolution, in that dtype, as flax does), BatchNorm computes
its statistics and the normalization in float32 and returns the compute
dtype (`float_output` returns float32, the 3D norm's rule). Parameters and
running statistics stay float32.

In a data-parallel step (`parallel.distributed.sharded`) every BatchNorm
takes its training statistics over the global batch, all ranks' rows: the
JAX package's norms bind no axis name, but its jit-global program over a
batch-sharded mesh computes them over the whole batch, whichever norm the
config names ('BN', 'nnSyncBN', 'batch', 'sync_batch').
"""
from __future__ import annotations

import math
import warnings
from typing import List

import torch
from torch import nn
import torch.nn.functional as F

from ..parallel import distributed
from .resnetfc import compute_dtype_of

# flax's truncated_normal keeps the variance: its stddev is divided by the
# standard deviation of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor) -> torch.Tensor:
    """flax's lecun_normal for a conv or dense weight (fan_in = every axis but the first)."""
    fan_in = weight[0].numel()
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(weight, std=std, a=-2.0 * std, b=2.0 * std)


class _CastConv:
    """A convolution computing in `compute_dtype` (flax's nn.Conv with
    `dtype=`): input and weight cast to it, the bias added afterwards.
    None computes in the weight's dtype (a float64 copy of a float32 model
    computes in float64), the bias fused as in the torch convolution."""

    compute_dtype = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return self._conv_forward(x.to(self.weight.dtype), self.weight, self.bias)
        y = self._conv_forward(x.to(dt), self.weight.to(dt), None)
        if self.bias is not None:
            y = y + self.bias.to(dt).reshape(-1, *([1] * (y.dim() - 2)))
        return y


class Conv2d(_CastConv, nn.Conv2d):
    pass


class Conv3d(_CastConv, nn.Conv3d):
    pass


class ConvTranspose2d(_CastConv, nn.ConvTranspose2d):
    def _conv_forward(self, x, weight, bias):
        return F.conv_transpose2d(x, weight, bias, self.stride, self.padding,
                                  self.output_padding, self.groups, self.dilation)


def cast_conv(cls, *args, dtype: torch.dtype = torch.float32, **kwargs):
    """`cls(*args, **kwargs)`, one of the cast convolutions, computing in
    `dtype` (torch's initialization)."""
    conv = cls(*args, **kwargs)
    conv.compute_dtype = compute_dtype_of(dtype)
    return conv


def _lecun_conv(cls, in_ch: int, out_ch: int, kernel: int, stride: int, padding: int,
                bias: bool, dtype: torch.dtype):
    conv = cast_conv(cls, in_ch, out_ch, kernel, stride, padding, bias=bias, dtype=dtype)
    lecun_normal_(conv.weight)
    if bias:
        nn.init.zeros_(conv.bias)
    return conv


def conv2d(in_ch: int, out_ch: int, kernel: int, stride: int = 1, padding: int = 0,
           bias: bool = False, dtype: torch.dtype = torch.float32) -> Conv2d:
    return _lecun_conv(Conv2d, in_ch, out_ch, kernel, stride, padding, bias, dtype)


def conv3d(in_ch: int, out_ch: int, kernel: int, stride: int = 1, padding: int = 0,
           bias: bool = False, dtype: torch.dtype = torch.float32) -> Conv3d:
    return _lecun_conv(Conv3d, in_ch, out_ch, kernel, stride, padding, bias, dtype)


class BatchNorm(nn.Module):
    """flax-semantics BatchNorm over (B, C, ...) of any rank (see the module
    docstring): statistics and normalization in float32 (float64 stays
    float64), the result in the compute dtype `dtype`, or in float32 at
    least with `float_output`. `zero_init` starts the scale at 0.

    Under a narrower compute dtype the statistics and the normalization
    take flax's own expressions (mean and E[x^2] - E[x]^2; (x - mean) *
    (rsqrt(var + eps) * scale) + bias, op by op), so that the float32 values
    that feed the next bf16 rounding are flax's; in float32 the two-pass
    variance and the fused F.batch_norm serve."""

    def __init__(self, channels: int, momentum: float = 0.9, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32, float_output: bool = False,
                 zero_init: bool = False):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.out_dtype = torch.promote_types(dtype, torch.float32) if float_output else dtype
        self.flax_expressions = torch.promote_types(dtype, torch.float32) != dtype
        self.weight = nn.Parameter(torch.zeros(channels) if zero_init else torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, update_stats: bool = True) -> torch.Tensor:
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        if not self.training:
            mean, var = self.running_mean, self.running_var
            if not self.flax_expressions:
                return F.batch_norm(x, mean, var, self.weight, self.bias, False, 0.0, self.eps)
        elif distributed.active():
            mean, var = self._global_statistics(x)
            self._update(mean, var, update_stats)
        elif self.flax_expressions:
            dims = (0,) + tuple(range(2, x.dim()))
            mean = x.mean(dims)
            var = torch.clamp_min((x * x).mean(dims) - mean * mean, 0.0)
            self._update(mean, var, update_stats)
        else:
            var, mean = torch.var_mean(x, dim=(0,) + tuple(range(2, x.dim())), unbiased=False)
            self._update(mean, var, update_stats)
            return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)
        return y.to(self.out_dtype)

    def _global_statistics(self, x: torch.Tensor):
        """Mean and biased variance over every rank's batch of a sharded
        step (the JAX package's jit-global statistics): under bf16 flax's
        E[x^2] - E[x]^2 from one reduction of the sums of x and x^2, in
        float32 two passes (the mean, then the squared deviations); their
        backward is that of the global statistics (`shared_sum`)."""
        dims = (0,) + tuple(range(2, x.dim()))
        count = x.numel() // x.shape[1] * distributed.shard_count()
        if self.flax_expressions:
            sums = distributed.shared_sum(torch.stack([x.sum(dims), (x * x).sum(dims)]))
            mean = sums[0] / count
            return mean, torch.clamp_min(sums[1] / count - mean * mean, 0.0)
        mean = distributed.shared_sum(x.sum(dims)) / count
        shape = (1, -1) + (1,) * (x.dim() - 2)
        dev = x - mean.reshape(shape)
        return mean, distributed.shared_sum((dev * dev).sum(dims)) / count

    @torch.no_grad()
    def _update(self, mean: torch.Tensor, var: torch.Tensor, update_stats: bool) -> None:
        if update_stats:
            self.running_mean.mul_(self.momentum).add_(mean, alpha=1 - self.momentum)
            self.running_var.mul_(self.momentum).add_(var, alpha=1 - self.momentum)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        state_dict.pop(prefix + "num_batches_tracked", None)  # torch's counter
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = conv2d(inplanes, planes, 3, stride, 1, dtype=dtype)
        self.bn1 = BatchNorm(planes, dtype=dtype)
        self.conv2 = conv2d(planes, planes, 3, 1, 1, dtype=dtype)
        self.bn2 = BatchNorm(planes, dtype=dtype)
        self.downsample = (nn.ModuleList([conv2d(inplanes, planes, 1, stride, dtype=dtype),
                                          BatchNorm(planes, dtype=dtype)])
                           if downsample else None)

    def forward(self, x: torch.Tensor, update_stats: bool = True) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x), update_stats))
        out = self.bn2(self.conv2(out), update_stats)
        identity = x if self.downsample is None else self.downsample[1](
            self.downsample[0](x), update_stats)
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = conv2d(inplanes, planes, 1, dtype=dtype)
        self.bn1 = BatchNorm(planes, dtype=dtype)
        self.conv2 = conv2d(planes, planes, 3, stride, 1, dtype=dtype)
        self.bn2 = BatchNorm(planes, dtype=dtype)
        self.conv3 = conv2d(planes, planes * 4, 1, dtype=dtype)
        self.bn3 = BatchNorm(planes * 4, dtype=dtype)
        self.downsample = (nn.ModuleList([conv2d(inplanes, planes * 4, 1, stride, dtype=dtype),
                                          BatchNorm(planes * 4, dtype=dtype)])
                           if downsample else None)

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
    [stem, stage1, ..., stage_num_stages] (B, C, H, W) maps in the compute
    dtype.

    `norm_type` is the JAX module's: every norm is BatchNorm whatever its
    value, as the JAX ResNet builds `nn.BatchNorm` for each ('sync_batch'
    only binds an axis name, the same norm on one card); any value other
    than 'batch' or 'sync_batch' ('instance', 'group', 'none', ...) is
    ignored there too, so it computes BatchNorm here and warns."""

    def __init__(self, backbone: str = "resnet34", num_stages: int = 4,
                 use_first_pool: bool = True, dtype: torch.dtype = torch.float32,
                 norm_type: str = "batch"):
        super().__init__()
        if norm_type not in ("batch", "sync_batch"):
            warnings.warn(f"spatial.norm_type {norm_type!r} computes BatchNorm: the JAX "
                          f"package's ResNet ignores it and builds BatchNorm for every value")
        block_cls, layer_counts = RESNET_SPECS[backbone]
        self.use_first_pool = use_first_pool
        self.conv1 = conv2d(3, 64, 7, 2, 3, dtype=dtype)
        self.bn1 = BatchNorm(64, dtype=dtype)
        self.stages = []
        inplanes, planes = 64, 64
        for stage in range(num_stages):
            blocks = nn.ModuleList()
            for b in range(layer_counts[stage]):
                stride = (1 if stage == 0 else 2) if b == 0 else 1
                out = planes * block_cls.expansion
                blocks.append(block_cls(inplanes, planes, stride,
                                        downsample=b == 0 and (stride != 1 or inplanes != out),
                                        dtype=dtype))
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
