"""Point-wise TSDF head (counterpart of gennerf_tpu/models/heads.py
TSDFHeadSimple). Parameter name head_geo.fc as in the reference checkpoint."""
from __future__ import annotations

import torch
from torch import nn


class TSDFHeadSimple(nn.Module):
    """Linear -> tanh, scaled by `smoothing` after the tanh (1.0 leaves the
    reference head math unchanged)."""

    def __init__(self, d_in: int, smoothing: float = 1.0):
        super().__init__()
        self.fc = nn.Linear(d_in, 1)
        nn.init.xavier_uniform_(self.fc.weight, gain=5.0 / 3.0)
        nn.init.zeros_(self.fc.bias)
        self.smoothing = float(smoothing)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.tanh(self.fc(x))
        return y if self.smoothing == 1.0 else y * self.smoothing
