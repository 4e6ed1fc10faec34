"""Model FLOPs of gennerf_living, counted from the configuration's shapes:
two per multiply-add of every matrix product and convolution (the
PointNet's layers, the plane UNet, ResnetFC and the head); sampling,
farthest points, activations and the positional code are left out.

A reconstruct request: one scene's encode (T frames of sparse points) and
the decode of every voxel of voxel_dim_test. A training step: the batch's
encode and the decode of its ray samples, forward and backward (three
times the forward: the backward's two products per forward one), without
recompute.
"""
from __future__ import annotations

import math


def _linear(n_in: int, n_out: int) -> int:
    return 2 * n_in * n_out


def pointnet_point_flops(cfg: dict) -> int:
    pn = cfg["model"]["encoder"]["pointnet"]
    h, c = pn["hidden_dim"], pn["c_dim"]
    f = _linear(pn["dim"], 2 * h)
    for _ in range(pn["n_blocks"]):
        f += _linear(2 * h, h) + _linear(h, h) + _linear(2 * h, h)  # fc_0, fc_1, shortcut
    return f + _linear(h, c)


def unet_flops(cfg: dict) -> int:
    """One plane of the shared UNet (3x3 convolutions, 2x2 stride-2
    transposed convolutions, the final 1x1)."""
    pn = cfg["model"]["encoder"]["pointnet"]
    r, c = pn["plane_resolution"], pn["c_dim"]
    depth, s = pn["unet_kwargs"]["depth"], pn["unet_kwargs"]["start_filts"]
    f, cin, side = 0, c, r
    for i in range(depth):
        cout = s * 2 ** i
        f += 2 * 9 * side * side * (cin * cout + cout * cout)
        cin = cout
        if i < depth - 1:
            side //= 2
    for _ in range(depth - 1):
        cout = cin // 2
        f += 2 * 4 * side * side * cin * cout          # transposed conv, per input pixel
        side *= 2
        f += 2 * 9 * side * side * (2 * cout * cout + cout * cout)
        cin = cout
    return f + 2 * side * side * cin * c


def encode_flops(cfg: dict, scenes: int) -> int:
    pn = cfg["model"]["encoder"]["pointnet"]
    points = cfg["num_frames"] * pn["num_sparse_points"]
    return scenes * (points * pointnet_point_flops(cfg) + len(pn["plane_type"]) * unet_flops(cfg))


def decode_point_flops(cfg: dict) -> int:
    m = cfg["model"]
    mlp, code = m["mlp"], m["code"]
    d_code = code["num_freqs"] * 2 * 3 + (3 if code["include_input"] else 0)
    H, nb = mlp["d_hidden"], mlp["n_blocks"]
    d_in = m["encoder"]["pointnet"]["c_dim"]
    return (_linear(d_in, H) + nb * (_linear(d_code, H) + 2 * _linear(H, H))
            + _linear(H, mlp["d_out_geo"] + mlp["d_out_sem"]) + _linear(mlp["d_out_geo"], 1))


def request_flops(cfg: dict) -> float:
    return float(encode_flops(cfg, 1) + math.prod(cfg["voxel_dim_test"]) * decode_point_flops(cfg))


def step_flops(cfg: dict) -> float:
    ray = cfg["model"]["ray"]
    points = cfg["batch_size"] * cfg["num_frames"] * ray["num_rays"] * (1 + ray["N"] + ray["M"])
    return 3.0 * (encode_flops(cfg, cfg["batch_size"]) + points * decode_point_flops(cfg))
