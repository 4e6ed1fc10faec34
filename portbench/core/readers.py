"""Arithmetic shared by the per-layer metric readers (metrics/<name>.py).

A reader takes a `Reading` and returns its metric's number, or None when
the traced window holds nothing it reads (no device operation, no launch of
its kernel): the harness then leaves the metric out of the line. A share
of a roofline or of a peak is never made up as 0.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from . import peaks


@dataclass
class Reading:
    cfg: dict                  # the configuration file
    counts: object             # counts/<config>.py
    trace: Optional[dict]      # core.trace.Window.summary()
    window_s: float
    chips: int
    work: dict                 # requests, steps, items in the window
    shapes: dict = field(default_factory=dict)  # the driver's work_counts


def kernels_named(r: Reading, *parts: str):
    """The traced kernels whose name holds every one of `parts`."""
    if not r.trace:
        return []
    return [k for k in r.trace["kernels"] if all(p in k[0] for p in parts)]


def idle_share(r: Reading) -> Optional[float]:
    """% of the window in which no operation ran on the device."""
    if not r.trace or not r.trace["device_ops"] or r.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace["busy_s"] / r.window_s)


def mfu(r: Reading, flops_per_unit: float, units: int) -> Optional[float]:
    """% of the bf16 dense peak of the chips over the window."""
    if not units or r.window_s <= 0 or not r.trace or not r.trace["device_ops"]:
        return None
    return 100.0 * flops_per_unit * units / (r.window_s * peaks.PEAK_BF16 * r.chips)


def roofline(r: Reading, launches, flops: float, nbytes: float, peak: float) -> Optional[float]:
    """% of the kernel's device time that its roofline bound would take."""
    if not launches:
        return None
    t = sum(d for _, _, d in launches)
    return 100.0 * len(launches) * peaks.roofline_seconds(flops, nbytes, peak) / t
