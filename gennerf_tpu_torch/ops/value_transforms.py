"""Scalar value transforms of the TSDF loss (counterpart of
gennerf_tpu/ops/value_transforms.py)."""
from __future__ import annotations

import torch


def log_transform(x: torch.Tensor, shift: float = 1.0) -> torch.Tensor:
    """sign(x) * log(1 + |x|/shift): weights voxels near the surface more."""
    return torch.sign(x) * torch.log1p(torch.abs(x) / shift)


def smooth_log_transform(x: torch.Tensor, shift: float = 1.0, beta: float = 1.0) -> torch.Tensor:
    """tanh(x) * softplus(beta*|x|/shift) / beta.

    The softplus is written as logaddexp(z, 0), the reference's
    jax.nn.softplus: F.softplus turns linear past beta*x > 20, which
    changes values and gradients there."""
    v = torch.abs(x) / shift
    z = beta * v
    return torch.tanh(x) * torch.logaddexp(z, torch.zeros_like(z)) / beta
