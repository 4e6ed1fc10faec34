"""2D U-Net smoothing the triplanes (counterpart of gennerf_tpu/models/unet.py).

NCHW throughout. Per level two 3x3 convs + ReLU and a 2x2 max-pool down;
2x2 stride-2 transposed convs up, concatenated with the skip (the 'concat'
merge; config.check_supported rejects 'add'), then two 3x3 convs + ReLU;
a final 1x1 conv. Parameter names follow the
reference (down_convs.{i}.conv1|conv2, up_convs.{i}.upconv|conv1|conv2,
conv_final). flax's ConvTranspose kernel is the spatial flip of torch's
(utils/port_params.py maps it).

Every convolution computes as flax's nn.Conv / nn.ConvTranspose with
`dtype=` do (models/resnet.py's cast convolutions): input and weight in
the compute `dtype` (bf16-mixed; float32 by default), the bias added
afterwards in it; the output is in it too. Parameters stay float32.
"""
from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from .resnet import Conv2d, ConvTranspose2d, cast_conv


class _DownConv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, pooling: bool,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = cast_conv(Conv2d, in_channels, out_channels, 3, padding=1, dtype=dtype)
        self.conv2 = cast_conv(Conv2d, out_channels, out_channels, 3, padding=1, dtype=dtype)
        self.pooling = pooling

    def forward(self, x):
        x = F.relu(self.conv1(x))
        x = F.relu(self.conv2(x))
        before_pool = x
        if self.pooling:
            x = F.max_pool2d(x, 2, 2)
        return x, before_pool


class _UpConv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.upconv = cast_conv(ConvTranspose2d, in_channels, out_channels, 2, stride=2,
                                dtype=dtype)
        self.conv1 = cast_conv(Conv2d, 2 * out_channels, out_channels, 3, padding=1, dtype=dtype)
        self.conv2 = cast_conv(Conv2d, out_channels, out_channels, 3, padding=1, dtype=dtype)

    def forward(self, from_down, from_up):
        x = torch.cat([self.upconv(from_up), from_down], dim=1)
        x = F.relu(self.conv1(x))
        return F.relu(self.conv2(x))


class UNet(nn.Module):
    def __init__(self, num_classes: int, in_channels: int, depth: int = 5,
                 start_filts: int = 64, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.down_convs = nn.ModuleList()
        outs = in_channels
        for i in range(depth):
            ins, outs = outs, start_filts * 2**i
            self.down_convs.append(_DownConv(ins, outs, pooling=i < depth - 1, dtype=dtype))
        self.up_convs = nn.ModuleList()
        for _ in range(depth - 1):
            ins, outs = outs, outs // 2
            self.up_convs.append(_UpConv(ins, outs, dtype))
        self.conv_final = cast_conv(Conv2d, outs, num_classes, 1, dtype=dtype)
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                nn.init.xavier_normal_(m.weight)
                nn.init.zeros_(m.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        encoder_outs = []
        for down in self.down_convs:
            x, before_pool = down(x)
            encoder_outs.append(before_pool)
        for i, up in enumerate(self.up_convs):
            x = up(encoder_outs[-(i + 2)], x)
        return self.conv_final(x)
