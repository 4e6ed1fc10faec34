"""The card's data-sheet peaks and what the run reads of the card itself.

NVIDIA H100 SXM5 data sheet, dense rates without sparsity, at the full
700 W power limit: 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s
float32 outside them, 3.35 TB/s of HBM3. A card set below 700 W runs
slower under load: its limit is printed beside every share of a peak."""
from __future__ import annotations

import subprocess

PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12


def power_limit() -> str:
    """nvidia-smi's name and power limit of the cards, or why not."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return out.stdout.strip().replace("\n", "; ") or out.stderr.strip()


def roofline_seconds(flops: float, nbytes: float, peak_flops: float) -> float:
    """The least time the card could take: the larger of operations over
    the peak rate and bytes over the memory bandwidth."""
    return max(flops / peak_flops, nbytes / PEAK_BYTES)
