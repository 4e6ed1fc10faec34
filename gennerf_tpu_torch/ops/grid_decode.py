"""Separable dense-grid TSDF decode (counterpart of
gennerf_tpu/ops/pallas/fused_decoder.py, grid part).

On a regular grid the triplane bilinear sample factors per axis, and the
positional encoding splits into three axis tables with disjoint columns:
    feat(i,j,k) = P_xz[i,k] + P_xy[i,j] + P_yz[j,k]
    code(i,j,k) = T_x[i] + T_y[j] + T_z[k]
lin_in and every lin_z are linear, so they are applied to the tables here
(`grid_tables`, small torch matmuls), and per point only the H x H
residual blocks and the folded head remain. Those run in the CUDA kernel
csrc/grid_decode.cu (the port of `_grid_kernel`) for CUDA tensors, and in
`separable_grid_decode_plain` otherwise.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..utils.spans import count
from . import kernels
from .coords import linspace


class GridTables(NamedTuple):
    """Pre-projected axis tables, all f32: q_yz (ny*nz, H) with b_in folded
    in, q_xz (nx, nz, H), q_xy (nx, ny, H), z_x (nx, nb, H), z_y (nb, ny, H),
    z_z (nb, nz, H) with alpha and bz folded in."""

    q_yz: torch.Tensor
    q_xz: torch.Tensor
    q_xy: torch.Tensor
    z_x: torch.Tensor
    z_y: torch.Tensor
    z_z: torch.Tensor


def supports_grid_decode(cfg) -> bool:
    """Whether the decoder config matches the separable decode (ReLU, no
    SPADE or LayerNorm, no combine inside the blocks, positional code)."""
    m = cfg.mlp
    return (
        m.beta == 0.0 and not m.use_spade and not m.use_layer_norm
        and m.combine_layer >= m.n_blocks and cfg.use_code
    )


@torch.no_grad()
def extract_resnetfc_weights(mlp, head, d_geo: int, head_smoothing: float = 1.0) -> dict:
    """Pack a ResnetFC and its TSDFHeadSimple into the decode's arrays
    (f32, (in, out) layout, on the modules' device).

    lin_out and the head fold into one column, w_last = w_out[:, :d_geo] @
    w_head, and one scalar b_last = b_out[:d_geo] @ w_head + b_head, both
    taken in f64: tanh(relu(x) @ w_last + b_last) is the head's output for
    any head bias. The scalars alpha, b_last and the post-tanh smoothing
    ride along."""
    n_blocks = len(mlp.blocks)
    f32, f64 = torch.float32, torch.float64

    def stack(ts):
        return torch.stack([t.detach() for t in ts]).to(f32).contiguous()

    w_out = mlp.lin_out.weight.detach().T  # (H, d_out)
    w_head = head.fc.weight.detach().T  # (d_geo, 1)
    w_last = (w_out[:, :d_geo].to(f64) @ w_head.to(f64))[:, 0]
    b_last = float(mlp.lin_out.bias.detach()[:d_geo].to(f64) @ w_head[:, 0].to(f64)
                   + head.fc.bias.detach()[0].to(f64))
    return {
        "w_in": mlp.lin_in.weight.detach().T.to(f32).contiguous(),
        "b_in": mlp.lin_in.bias.detach().to(f32),
        "wz": stack(mlp.lin_z[i].weight.T for i in range(n_blocks)),
        "bz": stack(mlp.lin_z[i].bias for i in range(n_blocks)),
        "w0": stack(mlp.blocks[i].fc_0.weight.T for i in range(n_blocks)),
        "b0": stack(mlp.blocks[i].fc_0.bias for i in range(n_blocks)),
        "w1": stack(mlp.blocks[i].fc_1.weight.T for i in range(n_blocks)),
        "b1": stack(mlp.blocks[i].fc_1.bias for i in range(n_blocks)),
        "w_last": w_last.to(f32),
        "b_last": b_last,
        "alpha": float(mlp.alpha),
        "smoothing": float(head_smoothing),
    }


def resample_matrix(u: torch.Tensor, reso: int) -> torch.Tensor:
    """(n,) normalized coords in [0,1) -> (n, reso) bilinear weight rows
    (grid_sample align_corners=True, border: two taps clamped into range)."""
    t = u * (reso - 1)
    lo = torch.floor(t)
    w = (t - lo)[:, None]
    lo_i = lo.to(torch.int64).clamp(0, reso - 1)
    hi_i = (lo_i + 1).clamp(0, reso - 1)
    eye = torch.eye(reso, dtype=u.dtype, device=u.device)
    return eye[lo_i] * (1.0 - w) + eye[hi_i] * w


def normalize_axis(c: torch.Tensor, padding: float) -> torch.Tensor:
    """normalize_coordinate on one axis."""
    u = c / (1.0 + padding + 10e-6) + 0.5
    return u.clamp(0.0, 1.0 - 10e-6)


def resample_plane(plane: torch.Tensor, wh: torch.Tensor, ww: torch.Tensor) -> torch.Tensor:
    """Separable bilinear resample of a (C, H, W) plane -> (nw, nh, C)."""
    C, H, W = plane.shape
    p = plane.permute(1, 2, 0)  # (H, W, C)
    q = (wh @ p.reshape(H, W * C)).reshape(-1, W, C)  # (nh, W, C)
    q = q.permute(1, 0, 2).reshape(W, -1)  # (W, nh*C)
    return (ww @ q).reshape(ww.shape[0], wh.shape[0], C)


def pe_axis_table(c: torch.Tensor, axis: int, num_freqs: int, freq_factor: float,
                  include_input: bool) -> torch.Tensor:
    """(n,) axis coords -> (n, d_code) table holding this axis's columns of
    positional_encoding's interleaved layout (zeros elsewhere)."""
    n = c.shape[0]
    d_code = num_freqs * 2 * 3 + (3 if include_input else 0)
    t = torch.zeros(n, d_code, dtype=c.dtype, device=c.device)
    off = 3 if include_input else 0
    if include_input:
        t[:, axis] = c
    for f in range(num_freqs):
        freq = freq_factor * 2.0**f
        t[:, off + (2 * f) * 3 + axis] = torch.sin(freq * c)
        t[:, off + (2 * f + 1) * 3 + axis] = torch.sin(freq * c + math.pi * 0.5)
    return t


@torch.no_grad()
def grid_tables(plane_xz, plane_xy, plane_yz, origin, weights: dict, *, voxel_dim,
                voxel_size: float, num_freqs: int, freq_factor: float, include_input: bool,
                padding: float, coord_center=None, coord_scale=None) -> GridTables:
    """The pre-projected axis tables of the decode grid.

    Planes are (C, reso, reso). World coordinates per axis follow the
    dense-grid convention (linspace over voxel_size * n, plus origin).
    coord_center/coord_scale map the PLANE coordinates only
    (pointnet.normalize_coords); the PE tables use world coordinates."""
    nx, ny, nz = (int(d) for d in voxel_dim)
    reso = plane_xz.shape[-1]
    f32 = torch.float32
    device = plane_xz.device
    origin = torch.as_tensor(origin, dtype=f32, device=device).reshape(3)
    alpha = torch.tensor(weights["alpha"], dtype=f32, device=device)
    w_in, wz, bz = weights["w_in"], weights["wz"], weights["bz"]

    axes = [linspace(0.0, voxel_size * n, n, device) + origin[a]
            for a, n in enumerate((nx, ny, nz))]
    plane_axes = axes
    if coord_center is not None:
        plane_axes = [(c - coord_center[a]) / coord_scale for a, c in enumerate(axes)]
    ws = [resample_matrix(normalize_axis(c, padding), reso) for c in plane_axes]

    def proj(p):
        return torch.einsum("abc,ch->abh", p, w_in)

    # plane width = first normalized coord, height = second ('xz': width x)
    q_xz = proj(resample_plane(plane_xz.to(f32), ws[2], ws[0]))
    q_xy = proj(resample_plane(plane_xy.to(f32), ws[1], ws[0]))
    q_yz = proj(resample_plane(plane_yz.to(f32), ws[2], ws[1])) + weights["b_in"]
    tabs = [pe_axis_table(axes[a], a, num_freqs, freq_factor, include_input) for a in range(3)]
    z_x, z_y, z_z = (alpha * torch.einsum("nd,bdh->bnh", t, wz) for t in tabs)
    z_z = z_z + alpha * bz[:, None, :]
    return GridTables(
        q_yz.reshape(ny * nz, -1).contiguous(), q_xz.contiguous(), q_xy.contiguous(),
        z_x.permute(1, 0, 2).contiguous(), z_y.contiguous(), z_z.contiguous(),
    )


def slab_tables(tables: GridTables, x0: int, x1: int) -> GridTables:
    """The tables of the grid's x-slab [x0, x1): the x tables (q_xz, q_xy,
    z_x) cut, the others whole; its decode is rows x0..x1-1 of the whole
    grid's."""
    q_yz, q_xz, q_xy, z_x, z_y, z_z = tables
    return GridTables(q_yz, q_xz[x0:x1].contiguous(), q_xy[x0:x1].contiguous(),
                      z_x[x0:x1].contiguous(), z_y, z_z)


def _feed(a: torch.Tensor, bf16_feeds: bool) -> torch.Tensor:
    """A product input: rounded to bf16 and held in f32 (the product of two
    bf16 values is exact in f32, so an f32 matmul of rounded inputs is a
    bf16-input, f32-accumulate product), or left in f32."""
    return a.to(torch.bfloat16).to(torch.float32) if bf16_feeds else a


@torch.no_grad()
def separable_grid_decode_plain(tables: GridTables, weights: dict,
                                bf16_feeds: bool = False) -> torch.Tensor:
    """Plain PyTorch decode of the tables, x-slab by x-slab -> (nx, ny, nz) f32.

    The semantics of separable_grid_decode_xla. bf16_feeds=False runs true
    f32 products (the JAX package's choice off the TPU, and the CPU path);
    bf16_feeds=True rounds every product input to bf16 with f32
    accumulation, mirroring the CUDA kernel (and the TPU kernel)."""
    q_yz, q_xz, q_xy, z_x, z_y, z_z = tables
    nx, nz, H = q_xz.shape
    ny = q_xy.shape[1]
    nb = z_y.shape[0]
    w0 = _feed(weights["w0"], bf16_feeds)
    w1 = _feed(weights["w1"], bf16_feeds)
    w_last = _feed(weights["w_last"], bf16_feeds)[:, None]
    b0, b1 = weights["b0"], weights["b1"]
    tz_yz = (z_y[:, :, None, :] + z_z[:, None, :, :]).reshape(nb, ny * nz, H)
    q_yz3 = q_yz.reshape(ny, nz, H)
    out = torch.empty(nx, ny * nz, dtype=torch.float32, device=q_yz.device)
    for i in range(nx):
        x = (q_yz3 + q_xz[i][None, :, :]) + q_xy[i][:, None, :]
        x = x.reshape(ny * nz, H)
        for b in range(nb):
            x = x + (tz_yz[b] + z_x[i, b][None, :])
            net = _feed(torch.relu(x), bf16_feeds) @ w0[b] + b0[b]
            dx = _feed(torch.relu(net), bf16_feeds) @ w1[b] + b1[b]
            x = x + dx
        head = (_feed(torch.relu(x), bf16_feeds) @ w_last)[:, 0]
        out[i] = torch.tanh(head + weights["b_last"]) * weights["smoothing"]
    return out.reshape(nx, ny, nz)


@torch.no_grad()
def grid_decode_cuda(tables: GridTables, weights: dict) -> torch.Tensor:
    """The grid-decode kernel on CUDA tables -> (nx, ny, nz) f32; `weights`
    from `pack_decode_weights(..., point=False)`."""
    q_yz, q_xz, q_xy, z_x, z_y, z_z = tables
    nx, nz, H = q_xz.shape
    ny = q_xy.shape[1]
    nb = z_y.shape[0]
    if H not in (128, 256, 512):
        raise NotImplementedError(f"grid decode kernel takes d_hidden 128, 256 or 512, got {H}")
    f32, bf16 = torch.float32, torch.bfloat16
    for name, t, shape in (("q_yz", q_yz, (ny * nz, H)), ("q_xz", q_xz, (nx, nz, H)),
                           ("q_xy", q_xy, (nx, ny, H)), ("z_x", z_x, (nx, nb, H)),
                           ("z_y", z_y, (nb, ny, H)), ("z_z", z_z, (nb, nz, H))):
        kernels.check_cuda_tensor(t, name, f32, shape)
    if weights.get("k_schedule") != "grid":
        raise ValueError("grid decode takes pack_decode_weights(weights, point=False)")
    w = weights
    for name, dtype, shape in (("k_slabs", bf16, (2 * nb * H * H,)), ("k_b0", f32, (nb, H)),
                               ("k_b1", f32, (nb, H)), ("k_w_last", bf16, (H,))):
        kernels.check_cuda_tensor(w[name], name, dtype, shape)
    out = torch.empty(nx * ny * nz, dtype=f32, device=q_yz.device)
    kernels.GRID_DECODE.launch(
        q_yz.data_ptr(), q_xz.data_ptr(), q_xy.data_ptr(),
        z_x.data_ptr(), z_y.data_ptr(), z_z.data_ptr(),
        w["k_slabs"].data_ptr(), w["k_b0"].data_ptr(), w["k_b1"].data_ptr(),
        w["k_w_last"].data_ptr(), float(w["b_last"]), float(w["smoothing"]), out.data_ptr(),
        nx, ny, nz, nb, H, kernels.stream_ptr(q_yz.device),
    )
    return out.reshape(nx, ny, nz)


def grid_decode(tables: GridTables, weights: dict) -> torch.Tensor:
    """Decode the tables: the kernel for CUDA tables, the plain f32 version
    for CPU tables (the JAX package's own off-TPU numerics). `weights` from
    `pack_decode_weights(..., point=False)`."""
    device = tables.q_yz.device
    count("decode.voxels", tables.q_xz.shape[0] * tables.q_xy.shape[1] * tables.q_xz.shape[1])
    if device.type == "cuda":
        return grid_decode_cuda(tables, weights)
    if device.type == "cpu":
        return separable_grid_decode_plain(tables, weights, bf16_feeds=False)
    raise ValueError(f"unsupported device {device}")


def grid_decode_flops(voxel_dim, H: int, n_blocks: int) -> int:
    """Tensor-core work of the kernel: two H x H products per block per
    point, plus the head's H-long dot."""
    n = int(voxel_dim[0]) * int(voxel_dim[1]) * int(voxel_dim[2])
    return n * (n_blocks * 2 * 2 * H * H + 2 * H)

