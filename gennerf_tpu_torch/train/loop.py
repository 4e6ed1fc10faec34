"""A minimal training loop (counterpart of gennerf_tpu/train/loop.py
`Trainer.fit`): epochs over a train loader with the learning rate set per
epoch, each batch moved to the model's device as it comes, a CSV row every
`log_every_n_steps`, the validation loss every `check_val_every_n_epoch`,
a checkpoint every epoch and resume from one. As in the reference, a
resumed run restarts the loaders' streams.

The host waits for the card only when it logs (every `log_every_n_steps`
and at an epoch's end): the step's metrics and timings stay on the device
until then, and a non-finite loss raises there.

Validation draws from its own generator (the run seed + 1), so how often
it runs does not change the training draws.

Not ported: the validation reconstruction and mesh tail, early stopping,
preemption, top-k checkpoints, the profiler and multi-device runs.
"""
from __future__ import annotations

import math
import os
import time
from typing import Dict, Iterable, List, Optional, Tuple

import torch

from ..models.gen_nerf import GenNerf
from .checkpoints import CheckpointManager, load_checkpoint, resolve_checkpoint
from .loggers import CSVLogger
from .state import lr_for_epoch, set_learning_rate
from .step import batch_to_device, eval_step, train_step


class Trainer:
    def __init__(self, model: GenNerf, optimizer: torch.optim.Optimizer,
                 generator: torch.Generator, out_dir: Optional[str] = None,
                 max_epochs: int = 1, log_every_n_steps: int = 50,
                 check_val_every_n_epoch: int = 1):
        """`generator` supplies every train step's draws, a second generator
        seeded with its initial seed + 1 the validation draws; with
        `out_dir`, metrics go to out_dir/metrics.csv and checkpoints to
        out_dir/checkpoints/."""
        self.model, self.optimizer, self.generator = model, optimizer, generator
        self.val_generator = torch.Generator(device=generator.device).manual_seed(
            generator.initial_seed() + 1)
        self.max_epochs = max_epochs
        self.log_every_n_steps = log_every_n_steps
        self.check_val_every_n_epoch = check_val_every_n_epoch
        self.logger = CSVLogger(out_dir, name="") if out_dir else None
        self.ckpt = CheckpointManager(os.path.join(out_dir, "checkpoints")) if out_dir else None
        self.global_step = 0
        self.metrics: Dict[str, float] = {}
        # per train step: host ms blocked on the loader, then ms of the step
        # (upload, forward, backward, optimizer) on the device's stream;
        # filled when the host next logs
        self.timings: List[Dict[str, float]] = []
        self._pending: List[Tuple[float, object, object]] = []

    def _log(self, metrics: Dict[str, float]) -> None:
        self.metrics.update(metrics)
        if self.logger is not None:
            self.logger.log_metrics(metrics, self.global_step)

    def fit(self, train_loader: Iterable[Dict], val_loader: Iterable[Dict] = (),
            ckpt_path: Optional[str] = None) -> Dict[str, float]:
        """Train to max_epochs over `train_loader` (iterated once an epoch;
        batches of numpy arrays or tensors); with `ckpt_path` (a checkpoint,
        or a directory holding last.pt) continue after the epoch it saved.
        Returns the last logged metrics."""
        device = next(self.model.parameters()).device
        start_epoch = 0
        if ckpt_path:
            info = load_checkpoint(resolve_checkpoint(ckpt_path), self.model, self.optimizer,
                                   self.generator, self.val_generator)
            start_epoch, self.global_step = info["epoch"] + 1, info["step"]
        cfg = self.model.cfg
        for epoch in range(start_epoch, self.max_epochs):
            lr = lr_for_epoch(cfg.optimizer, cfg.scheduler, epoch)
            set_learning_rate(self.optimizer, lr)
            metrics = None  # the last step's, not logged yet
            batches = iter(train_loader)
            while True:
                t0 = time.perf_counter()
                batch = next(batches, None)
                if batch is None:
                    break
                wait_ms = (time.perf_counter() - t0) * 1e3
                begin = _mark(device)
                metrics = train_step(self.model, self.optimizer, batch_to_device(batch, device),
                                     self.generator)
                self._pending.append((wait_ms, begin, _mark(device)))
                self.global_step += 1
                if self.global_step % self.log_every_n_steps == 0:
                    self._log_step(metrics, lr, epoch)
                    metrics = None
            if not (self.timings or self._pending):
                raise ValueError("the train loader yielded no batches")
            if metrics is not None:  # an epoch logs at least its last step
                self._log_step(metrics, lr, epoch)
            if val_loader and (epoch + 1) % self.check_val_every_n_epoch == 0:
                self._log(self.validate(val_loader))
            if self.ckpt is not None:
                self.ckpt.save(epoch, self.global_step, self.model, self.optimizer,
                               self.generator, self.val_generator)
        return dict(self.metrics)

    def _log_step(self, metrics: Dict[str, torch.Tensor], lr: float, epoch: int) -> None:
        """Wait for the step just launched, fill the pending timings and
        log its row; a non-finite loss raises."""
        for wait_ms, begin, end in self._pending:
            self.timings.append({"data_wait_ms": wait_ms, "step_ms": _elapsed_ms(begin, end)})
        self._pending.clear()
        row = {f"train_{k}": float(v) for k, v in metrics.items()}
        if not math.isfinite(row["train_combined"]):
            raise FloatingPointError(f"loss {row['train_combined']} at step {self.global_step}")
        self._log({**row, **self.timings[-1], "lr": lr, "epoch": epoch})

    def validate(self, loader: Iterable[Dict]) -> Dict[str, float]:
        """The eval metrics averaged over the loader's batches, keys
        prefixed `val_`, drawn from the validation generator."""
        device = next(self.model.parameters()).device
        sums: Dict[str, torch.Tensor] = {}
        count = 0
        for batch in loader:
            for k, v in eval_step(self.model, batch_to_device(batch, device),
                                  self.val_generator).items():
                sums[k] = v if k not in sums else sums[k] + v
            count += 1
        return {f"val_{k}": float(v) / max(count, 1) for k, v in sums.items()}


def _mark(device: torch.device):
    """A point in the device's work: an event recorded on the current CUDA
    stream, or the host clock on the CPU (where a step runs synchronously)."""
    if device.type == "cuda":
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event
    return time.perf_counter()


def _elapsed_ms(begin, end) -> float:
    if isinstance(begin, float):
        return (end - begin) * 1e3
    end.synchronize()
    return begin.elapsed_time(end)
