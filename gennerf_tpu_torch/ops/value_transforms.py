"""Scalar value transforms of the TSDF loss and the image blur of the
spatial encoder (counterpart of gennerf_tpu/ops/value_transforms.py)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .coords import linspace


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


def gaussian_kernel_1d(kernel_size: int, sigma: float, device=None) -> torch.Tensor:
    """Normalized 1D Gaussian on the reference's grid
    linspace(-(k//2), k//2, k) (rounded as the compiled jnp.linspace)."""
    half = float(kernel_size // 2)
    x = linspace(-half, half, kernel_size, device)
    g = torch.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return g / g.sum()


def apply_gaussian_smoothing(image: torch.Tensor, kernel_size: int, sigma: float) -> torch.Tensor:
    """Depthwise Gaussian blur of (B, C, H, W) with 'same' zero padding:
    the separable kernel as a column pass, then a row pass."""
    B, C, H, W = image.shape
    g = gaussian_kernel_1d(kernel_size, sigma, image.device).to(image.dtype)
    pad = kernel_size // 2
    x = image.reshape(B * C, 1, H, W)
    x = F.conv2d(x, g.reshape(1, 1, kernel_size, 1), padding=(pad, 0))
    x = F.conv2d(x, g.reshape(1, 1, 1, kernel_size), padding=(0, pad))
    return x.reshape(B, C, H, W)
