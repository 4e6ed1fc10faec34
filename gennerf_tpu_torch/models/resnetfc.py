"""Conditioned fully-connected ResNet decoder (counterpart of
gennerf_tpu/models/resnetfc.py). Parameter names follow the reference
checkpoint (mlp.lin_in / mlp.lin_z.{i} / mlp.blocks.{i}.fc_0|fc_1 /
mlp.lin_out / mlp.alpha)."""
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


class ResnetBlockFC(nn.Module):
    """Two-layer FC residual block: x_s + fc_1(act(fc_0(act(x)))), with a
    bias-free linear shortcut when the width changes."""

    def __init__(self, size_in: int, size_out: Optional[int] = None,
                 size_h: Optional[int] = None, beta: float = 0.0):
        super().__init__()
        size_out = size_out or size_in
        size_h = size_h or min(size_in, size_out)
        self.fc_0 = nn.Linear(size_in, size_h)
        self.fc_1 = nn.Linear(size_h, size_out)
        nn.init.zeros_(self.fc_1.weight)  # the block starts as identity
        self.shortcut = None if size_in == size_out else nn.Linear(size_in, size_out, bias=False)
        self.actvn = make_activation(beta)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        net = self.fc_0(self.actvn(x))
        dx = self.fc_1(self.actvn(net))
        x_s = x if self.shortcut is None else self.shortcut(x)
        return x_s + dx


class ResnetFC(nn.Module):
    """ResNet MLP with per-block latent injection. Input zx = concat(latent
    z (d_latent), features x (d_in)); x += alpha * lin_z_b(z) before block
    b. With the default combine_layer (>= n_blocks) and one view per point
    the reference's combine step is the identity, so it has no code here."""

    def __init__(self, d_in: int, d_out: int = 4, n_blocks: int = 5, d_latent: int = 0,
                 d_hidden: int = 128, beta: float = 0.0, combine_layer: int = 1000,
                 alpha: float = 1.0):
        super().__init__()
        self.d_latent = d_latent
        self.lin_in = nn.Linear(d_in, d_hidden)
        n_lin_z = min(combine_layer, n_blocks) if d_latent > 0 else 0
        self.lin_z = nn.ModuleList([nn.Linear(d_latent, d_hidden) for _ in range(n_lin_z)])
        self.blocks = nn.ModuleList([ResnetBlockFC(d_hidden, beta=beta) for _ in range(n_blocks)])
        self.lin_out = nn.Linear(d_hidden, d_out)
        self.alpha = nn.Parameter(torch.tensor(float(alpha)))
        self.actvn = make_activation(beta)

    def forward(self, zx: torch.Tensor) -> torch.Tensor:
        z = zx[..., : self.d_latent]
        x = self.lin_in(zx[..., self.d_latent:])
        for b, block in enumerate(self.blocks):
            if b < len(self.lin_z):
                x = x + self.alpha * self.lin_z[b](z)
            x = block(x)
        return self.lin_out(self.actvn(x))
