"""Model FLOPs of gennerf_living_spatial, counted from the configuration's
shapes by the rule of counts/gennerf_living.py (two per multiply-add of
every matrix product and convolution): gennerf_living's encode, its decode
with ResnetFC's first layer widened to d_in = c_dim + the spatial latent,
and each frame's 2D encoder: the depthwise Gaussian pre-blur (a column
pass and a row pass), the ResNet stem and the BasicBlocks of its first
num_layers - 1 stages (downsampling 1x1 convolutions included) at the
frame's size times feature_scale. BatchNorm, the resizes, the max-pool,
the backprojection and the volume's sampling are left out.
"""
from __future__ import annotations

import math

from portbench.counts.gennerf_living import _linear, decode_point_flops, encode_flops

BLOCKS = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3)}


def _conv(side_h: int, side_w: int, c_in: int, c_out: int, k: int) -> int:
    """A k x k convolution's FLOPs over an output of side_h x side_w."""
    return 2 * k * k * c_in * c_out * side_h * side_w


def latent(cfg: dict) -> int:
    """The concatenated maps' channels: the stem's 64, then each stage's."""
    stages = cfg["model"]["encoder"]["spatial"]["num_layers"] - 1
    return 64 + sum(64 * 2 ** s for s in range(stages))


def frame_flops(cfg: dict) -> int:
    """One frame through the blur and the ResNet's stem and stages."""
    sp = cfg["model"]["encoder"]["spatial"]
    H, W = cfg["frame_height"], cfg["frame_width"]
    f = 2 * 3 * H * W * 2 * sp["kernel_size"] if sp["blur_image"] else 0
    s = float(sp["feature_scale"])
    h, w = int(H * s), int(W * s)
    h, w = (h + 1) // 2, (w + 1) // 2          # the 7x7 stride-2 stem
    f += _conv(h, w, 3, 64, 7)
    if sp["use_first_pool"]:
        h, w = (h + 1) // 2, (w + 1) // 2
    c_in = 64
    for stage in range(sp["num_layers"] - 1):
        c = 64 * 2 ** stage
        for b in range(BLOCKS[sp["backbone"]][stage]):
            stride = 2 if (stage > 0 and b == 0) else 1
            if stride == 2:
                h, w = (h + 1) // 2, (w + 1) // 2
            f += _conv(h, w, c_in, c, 3) + _conv(h, w, c, c, 3)
            if stride != 1 or c_in != c:
                f += _conv(h, w, c_in, c, 1)
            c_in = c
    return f


def request_flops(cfg: dict) -> float:
    mlp = cfg["model"]["mlp"]
    widened = _linear(latent(cfg), mlp["d_hidden"])
    decode = math.prod(cfg["voxel_dim_test"]) * (decode_point_flops(cfg) + widened)
    return float(encode_flops(cfg, 1) + decode + cfg["num_frames"] * frame_flops(cfg))
