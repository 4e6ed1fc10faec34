"""The trainer's callback analogs (the port's copy of gennerf_tpu/train/
callbacks.py; the reference's configs/callbacks/ group):

- `summarize_params`: a depth-limited parameter table (model_summary);
- `ProgressBar`: one in-place progress line on stderr (rich_progress_bar),
  throttled so that it adds no host work to the step's cadence, and off
  when stderr is not a terminal;
- `clear_device_caches`: the reference's CudaClearCacheCallback
  (clear_cache): collect host garbage, then return the caching
  allocator's free blocks to the card (`torch.cuda.empty_cache`), and
  report what is still live.
"""
from __future__ import annotations

import gc
import sys
import time
from typing import Any, Dict, Optional

import torch


def summarize_params(model: torch.nn.Module, max_depth: int = -1) -> str:
    """A printable table of `model`'s parameters: one row per module,
    aggregated at `max_depth` levels of the dotted parameter names (-1:
    every level), with its parameter count, size and dtypes, and a totals
    footer."""
    rows: Dict[str, Dict[str, Any]] = {}
    for name, p in model.named_parameters():
        path = name.split(".")
        depth = len(path) - 1 if max_depth < 0 else min(max_depth, len(path) - 1)
        row = rows.setdefault("/".join(path[:depth]) or "(root)",
                              {"params": 0, "bytes": 0, "dtypes": set()})
        row["params"] += p.numel()
        row["bytes"] += p.numel() * p.element_size()
        row["dtypes"].add(str(p.dtype).removeprefix("torch."))
    name_w = max([len(k) for k in rows] + [len("module")]) + 2
    lines = [f"{'module':<{name_w}}{'params':>12}  {'size':>10}  dtype", "-" * (name_w + 32)]
    total_params = total_bytes = 0
    for key in sorted(rows):
        row = rows[key]
        total_params += row["params"]
        total_bytes += row["bytes"]
        lines.append(f"{key:<{name_w}}{row['params']:>12,}  {_human(row['bytes']):>10}  "
                     + ",".join(sorted(row["dtypes"])))
    lines.append("-" * (name_w + 32))
    lines.append(f"{'total':<{name_w}}{total_params:>12,}  {_human(total_bytes):>10}")
    return "\n".join(lines)


def _human(n: float) -> str:
    for unit in ("B", "KB", "MB", "GB"):
        if n < 1024 or unit == "GB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{n} B"
        n /= 1024.0
    return f"{n:.1f} GB"


class ProgressBar:
    """In-place single-line epoch progress, at most one write every
    `min_interval_s`. Without an explicit `stream` it writes to stderr and
    is off when stderr is not a terminal. `total` may be None (the first
    epoch's batch count is unknown)."""

    def __init__(self, enabled: bool = True, min_interval_s: float = 0.25, stream=None):
        self.enabled = bool(enabled)
        if stream is None:
            stream = sys.stderr
            if self.enabled and not getattr(stream, "isatty", lambda: False)():
                self.enabled = False
        self.min_interval_s = float(min_interval_s)
        self.stream = stream
        self._t_start = 0.0
        self._t_last = 0.0
        self._wrote = False

    def start_epoch(self, epoch: int, total: Optional[int] = None) -> None:
        self._epoch = epoch
        self._total = total
        self._t_start = time.time()
        self._t_last = 0.0
        self._wrote = False

    def update(self, step_in_epoch: int, metrics: Optional[Dict[str, float]] = None) -> None:
        """`metrics`: host floats already fetched (the line never waits for
        the card)."""
        if not self.enabled:
            return
        now = time.time()
        if now - self._t_last < self.min_interval_s:
            return
        self._t_last = now
        rate = step_in_epoch / max(now - self._t_start, 1e-9)
        frac = ""
        if self._total:
            frac = f"/{self._total} ({100.0 * step_in_epoch / self._total:3.0f}%)"
        line = f"epoch {self._epoch}: step {step_in_epoch}{frac}  {rate:5.1f} it/s"
        if metrics:
            shown = ", ".join(f"{k}={v:.4f}" for k, v in list(metrics.items())[:3])
            if shown:
                line += "  " + shown
        self.stream.write("\r" + line.ljust(79))
        self.stream.flush()
        self._wrote = True

    def end_epoch(self) -> None:
        if self.enabled and self._wrote:
            self.stream.write("\r" + " " * 79 + "\r")
            self.stream.flush()


def clear_device_caches(device, log=None, where: str = "") -> Dict[str, float]:
    """Collect host garbage so dropped tensors free their memory; on a CUDA
    `device` then hand the caching allocator's unused blocks back to the
    card. Returns {"live_buffers", "live_mb"}: the allocator's active
    allocations and allocated bytes on the card, or on the CPU the tensors
    the garbage collector still reaches and their bytes (logged to `log`
    when given)."""
    gc.collect()
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
        n = torch.cuda.memory_stats(device).get("active.all.current", 0)
        total = torch.cuda.memory_allocated(device)
    else:
        n = total = 0
        for obj in gc.get_objects():
            # type(), not isinstance(): a proxy object's __class__ may warn
            if issubclass(type(obj), torch.Tensor) and obj.device.type == "cpu":
                n += 1
                total += obj.numel() * obj.element_size()
    stats = {"live_buffers": float(n), "live_mb": total / (1024.0 * 1024.0)}
    if log is not None:
        log.info(f"clear_cache{f' ({where})' if where else ''}: "
                 f"{n} live device buffers, {stats['live_mb']:.1f} MB")
    return stats
