"""Conditioned fully-connected ResNet decoder (counterpart of
gennerf_tpu/models/resnetfc.py). Parameter names follow the reference
checkpoint (mlp.lin_in / mlp.lin_z.{i} / mlp.scale_z.{i} (SPADE) /
mlp.blocks.{i}.fc_0|fc_1 / mlp.lin_out / mlp.alpha); the LayerNorm after
each block (`use_layer_norm`) is mlp.ln.{i}, flax's LayerNorm.

Mixed precision follows flax's `nn.Dense(dtype=)`: a layer with a compute
`dtype` casts its input and weight to it, rounds the product to it and adds
the bias in it (two roundings, as flax; a fused bias would round once).
Parameters stay float32; without a compute dtype a layer runs in its
weight's dtype, fused as nn.Linear.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F


def make_activation(beta: float = 0.0):
    """ReLU, or softplus(beta*x)/beta when beta > 0."""
    if beta > 0:
        return lambda x: F.softplus(beta * x) / beta
    return torch.relu


def compute_dtype_of(dtype: torch.dtype) -> Optional[torch.dtype]:
    """A module's `dtype` argument -> its layers' compute dtype: None for
    float32 (the weight's own dtype, so a float64 copy computes in
    float64), else the dtype."""
    return None if dtype == torch.float32 else dtype


class Linear(nn.Linear):
    """nn.Linear computing in `compute_dtype` (flax's nn.Dense with
    `dtype=`): the product rounded to it, then the bias added in it."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return F.linear(x, self.weight, self.bias)
        y = F.linear(x.to(dt), self.weight.to(dt))
        return y if self.bias is None else y + self.bias.to(dt)


def linear(d_in: int, d_out: int, bias: bool = True,
           dtype: torch.dtype = torch.float32) -> Linear:
    layer = Linear(d_in, d_out, bias=bias)
    layer.compute_dtype = compute_dtype_of(dtype)
    return layer


class ResnetBlockFC(nn.Module):
    """Two-layer FC residual block: x_s + fc_1(act(fc_0(act(x)))), with a
    bias-free linear shortcut when the width changes."""

    def __init__(self, size_in: int, size_out: Optional[int] = None,
                 size_h: Optional[int] = None, beta: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        size_out = size_out or size_in
        size_h = size_h or min(size_in, size_out)
        self.fc_0 = linear(size_in, size_h, dtype=dtype)
        self.fc_1 = linear(size_h, size_out, dtype=dtype)
        nn.init.zeros_(self.fc_1.weight)  # the block starts as identity
        self.shortcut = (None if size_in == size_out
                         else linear(size_in, size_out, bias=False, dtype=dtype))
        self.actvn = make_activation(beta)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        net = self.fc_0(self.actvn(x))
        dx = self.fc_1(self.actvn(net))
        x_s = x if self.shortcut is None else self.shortcut(x)
        return x_s + dx


class LayerNorm(nn.Module):
    """flax's nn.LayerNorm over the last axis: epsilon 1e-6 (torch's
    default is 1e-5), the variance as E[x^2] - E[x]^2 clipped at 0 (flax's
    use_fast_variance), then (x - mean) * (rsqrt(var + eps) * weight) + bias,
    in float32 at least."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp_min((x * x).mean(-1, keepdim=True) - mean * mean, 0.0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


class ResnetFC(nn.Module):
    """ResNet MLP with per-block latent injection. Input zx = concat(latent
    z (d_latent), features x (d_in)); x += alpha * lin_z_b(z) before block
    b, or with `use_spade` x = scale_z_b(z) * x + alpha * lin_z_b(z);
    with `use_layer_norm` a LayerNorm follows each block. With the default
    combine_layer (>= n_blocks) and one view per point the reference's
    combine step is the identity, so it has no code here.

    Under a compute dtype the float32 `alpha` promotes the injection, and
    with it the residual stream, to float32 (JAX's promotion of an f32
    array times a bf16 one); the output is float32 at least."""

    def __init__(self, d_in: int, d_out: int = 4, n_blocks: int = 5, d_latent: int = 0,
                 d_hidden: int = 128, beta: float = 0.0, combine_layer: int = 1000,
                 alpha: float = 1.0, use_spade: bool = False, use_layer_norm: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.d_latent = d_latent
        self.lin_in = linear(d_in, d_hidden, dtype=dtype)
        n_lin_z = min(combine_layer, n_blocks) if d_latent > 0 else 0
        self.lin_z = nn.ModuleList([linear(d_latent, d_hidden, dtype=dtype)
                                    for _ in range(n_lin_z)])
        self.scale_z = (nn.ModuleList([linear(d_latent, d_hidden, dtype=dtype)
                                       for _ in range(n_lin_z)]) if use_spade else None)
        self.blocks = nn.ModuleList([ResnetBlockFC(d_hidden, beta=beta, dtype=dtype)
                                     for _ in range(n_blocks)])
        self.ln = (nn.ModuleList([LayerNorm(d_hidden) for _ in range(n_blocks)])
                   if use_layer_norm else None)
        self.lin_out = linear(d_hidden, d_out, dtype=dtype)
        self.alpha = nn.Parameter(torch.tensor(float(alpha)))
        self.actvn = make_activation(beta)

    def forward(self, zx: torch.Tensor) -> torch.Tensor:
        z = zx[..., : self.d_latent]
        x = self.lin_in(zx[..., self.d_latent:])
        for b, block in enumerate(self.blocks):
            if b < len(self.lin_z):
                tz = self.lin_z[b](z)
                # torch would keep a 0-dim alpha from promoting tz
                dt = torch.promote_types(torch.promote_types(self.alpha.dtype, tz.dtype), x.dtype)
                if self.scale_z is None:
                    x = x.to(dt) + self.alpha.to(dt) * tz.to(dt)
                else:
                    x = self.scale_z[b](z).to(dt) * x.to(dt) + self.alpha.to(dt) * tz.to(dt)
            x = block(x)
            if self.ln is not None:
                x = self.ln[b](x)
        out = self.lin_out(self.actvn(x))
        return out.to(torch.promote_types(torch.float32, zx.dtype))
