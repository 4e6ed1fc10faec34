"""Model FLOPs of voxelnet_living, counted from the configuration's shapes:
two per multiply-add of every convolution (the ResNet-50 stem and stages on
the rescaled frames, the projection of the concatenated stage maps at the
stem's size, the 3D encoder-decoder and the heads); resizes,
backprojection, norms and activations are left out. A training step is
three times the forward (its backward's two products per forward one),
without recompute."""
from __future__ import annotations

import math

BLOCKS = {"resnet50": (3, 4, 6, 3)}


def _conv(cin: int, cout: int, k: int, pixels: int) -> int:
    return 2 * cin * cout * k * pixels


def frame_flops(cfg: dict) -> int:
    sp = cfg["model"]["encoder"]["spatial"]
    h = int(cfg["frame_height"] * sp["feature_scale"]) // 2
    w = int(cfg["frame_width"] * sp["feature_scale"]) // 2
    f = _conv(3, 64, 49, h * w)
    stem_px, latent = h * w, 64
    if sp["use_first_pool"]:
        h, w = (h + 1) // 2, (w + 1) // 2
    cin, planes = 64, 64
    for stage in range(sp["num_layers"] - 1):
        for b in range(BLOCKS[sp["backbone"]][stage]):
            stride = 2 if (stage > 0 and b == 0) else 1
            f += _conv(cin, planes, 1, h * w)
            if stride == 2:
                h, w = (h + 1) // 2, (w + 1) // 2
            f += _conv(planes, planes, 9, h * w) + _conv(planes, 4 * planes, 1, h * w)
            if b == 0:
                f += _conv(cin, 4 * planes, 1, h * w)
            cin = 4 * planes
        latent += cin
        planes *= 2
    out = cfg["model"]["backbone3d"]["channels"][0]
    return f + _conv(latent, out, 1, stem_px)


def volume_flops(cfg: dict) -> int:
    b3 = cfg["model"]["backbone3d"]
    ch, down, up = b3["channels"], b3["layers_down"], b3["layers"]
    v = math.prod(cfg["voxel_dim_train"])
    f, sizes = 0, []
    for i, c in enumerate(ch):
        if i > 0:
            v //= 8
            f += _conv(ch[i - 1], c, 27, v)
        f += down[i] * 2 * _conv(c, c, 27, v)
        sizes.append(v)
    rev = ch[::-1]
    for i in range(len(ch) - 1):
        v = sizes[::-1][i + 1]
        f += _conv(rev[i], rev[i + 1], 1, v) + _conv(rev[i + 1], rev[i + 1], 1, v)
        f += up[i] * 2 * _conv(rev[i + 1], rev[i + 1], 27, v)
        f += _conv(rev[i + 1], 1, 1, v)  # the head of this scale
    return f


def step_flops(cfg: dict) -> float:
    items = cfg["batch_size"]
    return 3.0 * items * (cfg["num_frames"] * frame_flops(cfg) + volume_flops(cfg))
