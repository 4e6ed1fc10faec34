"""The traced window: torch.profiler over the measured window, reduced to
what the per-layer readers need. The device's busy time is the union of
the intervals in which an operation (kernel, copy or fill) ran on it; the
breakdown lists the device operations that took most time and the longest
idle gaps, each named by the innermost host operation running at the
gap's middle (and by the CUDA runtime call inside it, where there is one).
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

TOP = 10
NAME_CHARS = 120
SCAN_BACK = 50000  # host events looked at before a gap's middle, for its innermost one


def _on_device(ev) -> bool:
    return "CUDA" in str(ev.device_type())


def _is_device_op(ev, host_names) -> bool:
    """A kernel, copy or fill that ran on the card. The profiler also puts
    the host's annotated spans (record_function) on the device's timeline:
    those are not, and carry a host event's name, which no kernel does."""
    if not _on_device(ev):
        return False
    kind = getattr(ev, "activity_type", None)
    if kind is not None:
        kind = str(kind()).lower()
        return "kernel" in kind or "memcpy" in kind or "memset" in kind
    return ev.name() not in host_names


def _short(name: str) -> str:
    return name if len(name) <= NAME_CHARS else name[:NAME_CHARS - 3] + "..."


def union_seconds(intervals: List[Tuple[float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    """(total length of the union, the merged intervals) of (start, end) pairs."""
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), [(s, e) for s, e in merged]


class Window:
    """Times the measured window on the host clock and, with `trace`,
    profiles it. After the block: `seconds`, and with `trace` `summary()`."""

    def __init__(self, trace: bool):
        self.trace = trace
        self.prof = None
        self.seconds = 0.0

    def __enter__(self):
        if self.trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def stop(self) -> None:
        """End the window (the caller has synchronized the device)."""
        self.seconds = time.perf_counter() - self.t0

    def __exit__(self, *exc):
        if not self.seconds:
            self.stop()
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False

    def summary(self) -> Optional[Dict]:
        """{device_ops: [(name, start_s, dur_s)], kernels: the same without
        copies and fills, busy_s, idle_gaps: [(host op, seconds)] longest
        first, top_ops: [(name, total seconds)] largest first, cpu: [(name,
        start_s, end_s)]} of the traced window; None without a trace."""
        if self.prof is None:
            return None
        events = self.prof.profiler.kineto_results.events()
        host_names = {ev.name() for ev in events if not _on_device(ev)}
        dev, cpu = [], []
        for ev in events:
            s, d = ev.start_ns() * 1e-9, ev.duration_ns() * 1e-9
            if _is_device_op(ev, host_names):
                dev.append((ev.name(), s, d))
            elif not _on_device(ev):
                cpu.append((ev.name(), s, s + d))
        kernels = [e for e in dev if not e[0].startswith(("Memcpy", "Memset"))]
        busy, merged = union_seconds([(s, s + d) for _, s, d in dev])
        by_name: Dict[str, float] = defaultdict(float)
        for name, _, d in dev:
            by_name[_short(name)] += d
        top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1], merged[i + 1][0])
                       for i in range(len(merged) - 1)), reverse=True)[:TOP]
        cpu.sort(key=lambda e: e[1])
        starts = [c[1] for c in cpu]
        idle = []
        for length, s, e in gaps:
            mid = (s + e) / 2
            i = bisect.bisect_right(starts, mid)
            covering = sorted((c for c in cpu[max(0, i - SCAN_BACK):i] if c[2] >= mid),
                              key=lambda c: c[2] - c[1])
            names = [c[0] for c in covering]
            op = next((n for n in names if not n.startswith("cuda")), None)
            inner = names[0] if names else None
            label = " > ".join(dict.fromkeys(n for n in (op, inner) if n)) or "host idle"
            idle.append((_short(label), length))
        return {"device_ops": dev, "kernels": kernels, "busy_s": busy, "idle_gaps": idle,
                "top_ops": top_ops, "cpu": cpu}


def quarters(starts, seconds: float) -> list:
    """How many steps or requests started in each quarter of the window."""
    return [sum(1 for t in starts if q * seconds / 4 <= t < (q + 1) * seconds / 4)
            for q in range(4)]

