"""NeRF sin/cos positional encoding (counterpart of
gennerf_tpu/models/positional_encoding.py).

One fused sin(x*f + phase) with phases (0, pi/2) interleaved per frequency,
so the columns are [x (optional), sin(f0 x), cos(f0 x), sin(f1 x), ...]
with the input dimension innermost. The separable grid tables
(ops/grid_decode.py `pe_axis_table`) rely on this exact layout.
"""
from __future__ import annotations

import math

import torch


def positional_encoding_dim(num_freqs: int, d_in: int, include_input: bool) -> int:
    return num_freqs * 2 * d_in + (d_in if include_input else 0)


def positional_encoding(x: torch.Tensor, num_freqs: int = 6, freq_factor: float = math.pi,
                        include_input: bool = True) -> torch.Tensor:
    """(..., d_in) -> (..., num_freqs*2*d_in (+ d_in))."""
    freqs = freq_factor * 2.0 ** torch.arange(num_freqs, dtype=x.dtype, device=x.device)
    rep_freqs = torch.repeat_interleave(freqs, 2).reshape(1, -1, 1)  # (1, 2F, 1)
    phases = torch.zeros(2 * num_freqs, dtype=x.dtype, device=x.device)
    phases[1::2] = math.pi * 0.5
    phases = phases.reshape(1, -1, 1)
    lead = x.shape[:-1]
    flat = x.reshape(-1, 1, x.shape[-1])  # (N, 1, d_in)
    embed = torch.sin(flat * rep_freqs + phases).reshape(*lead, -1)
    if include_input:
        embed = torch.cat([x, embed], dim=-1)
    return embed
