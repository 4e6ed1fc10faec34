"""A minimal training loop (counterpart of gennerf_tpu/train/loop.py
`Trainer.fit`): epochs over the given batches with the learning rate set
per epoch, a CSV row every `log_every_n_steps`, the validation loss every
`check_val_every_n_epoch`, a checkpoint every epoch and resume from one.

Not ported: the validation reconstruction and mesh tail, early stopping,
preemption, top-k checkpoints, the profiler and multi-device runs.
"""
from __future__ import annotations

import os
from typing import Dict, Iterable, Optional

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
        """`generator` supplies every step's draws; with `out_dir`, metrics
        go to out_dir/metrics.csv and checkpoints to out_dir/checkpoints/."""
        self.model, self.optimizer, self.generator = model, optimizer, generator
        self.max_epochs = max_epochs
        self.log_every_n_steps = log_every_n_steps
        self.check_val_every_n_epoch = check_val_every_n_epoch
        self.logger = CSVLogger(out_dir, name="") if out_dir else None
        self.ckpt = CheckpointManager(os.path.join(out_dir, "checkpoints")) if out_dir else None
        self.global_step = 0
        self.metrics: Dict[str, float] = {}

    def _log(self, metrics: Dict[str, float]) -> None:
        self.metrics.update(metrics)
        if self.logger is not None:
            self.logger.log_metrics(metrics, self.global_step)

    def fit(self, train_batches: Iterable[Dict], val_batches: Iterable[Dict] = (),
            ckpt_path: Optional[str] = None) -> Dict[str, float]:
        """Train to max_epochs; with `ckpt_path` (a checkpoint, or a
        directory holding last.pt) continue after the epoch it saved.
        Returns the last logged metrics."""
        device = next(self.model.parameters()).device
        train_batches = [batch_to_device(b, device) for b in train_batches]
        val_batches = [batch_to_device(b, device) for b in val_batches]
        if not train_batches:
            raise ValueError("no training batches")
        start_epoch = 0
        if ckpt_path:
            info = load_checkpoint(resolve_checkpoint(ckpt_path), self.model, self.optimizer,
                                   self.generator)
            start_epoch, self.global_step = info["epoch"] + 1, info["step"]
        cfg = self.model.cfg
        for epoch in range(start_epoch, self.max_epochs):
            lr = lr_for_epoch(cfg.optimizer, cfg.scheduler, epoch)
            set_learning_rate(self.optimizer, lr)
            logged = False
            for batch in train_batches:
                metrics = train_step(self.model, self.optimizer, batch, self.generator)
                self.global_step += 1
                if self.global_step % self.log_every_n_steps == 0:
                    logged = True
                    self._log({**{f"train_{k}": float(v) for k, v in metrics.items()},
                               "lr": lr, "epoch": epoch})
            if not logged:  # an epoch logs at least its last step
                self._log({**{f"train_{k}": float(v) for k, v in metrics.items()},
                           "lr": lr, "epoch": epoch})
            if val_batches and (epoch + 1) % self.check_val_every_n_epoch == 0:
                self._log(self.validate(val_batches))
            if self.ckpt is not None:
                self.ckpt.save(epoch, self.global_step, self.model, self.optimizer, self.generator)
        return dict(self.metrics)

    def validate(self, batches) -> Dict[str, float]:
        """The eval metrics averaged over the batches, keys prefixed `val_`."""
        sums: Dict[str, torch.Tensor] = {}
        for batch in batches:
            for k, v in eval_step(self.model, batch, self.generator).items():
                sums[k] = v if k not in sums else sums[k] + v
        return {f"val_{k}": float(v) / len(batches) for k, v in sums.items()}
