"""A minimal training loop (counterpart of gennerf_tpu/train/loop.py
`Trainer.fit`): epochs over a train loader with the learning rate set per
epoch, each batch moved to the model's device as it comes, a CSV row every
`log_every_n_steps`, validation every `check_val_every_n_epoch`, a
checkpoint every epoch (kept by `CheckpointManager`'s rule, ranked by the
validation metrics) and resume from one. As in the reference, a resumed
run restarts the loaders' streams.

The host waits for the card only when it logs (every `log_every_n_steps`
and at an epoch's end): the step's metrics and timings stay on the device
until then, and a non-finite loss raises there.

Validation draws from its own generator (the run seed + 1), so how often
it runs does not change the training draws. It ends with the reference's
reconstruction tail: batch element 0 of the last batch is reconstructed at
its ground truth's grid (`predict.reconstruct`, which also encodes a
feature volume on that grid; the encoder's draws from the validation
generator), `{mode}_recon_tsdf_l1` is the unmasked mean
|pred - target| over that grid, and with an output directory the two
TSDFs (.npz) and their meshes (.ply, empty ones too) go to its local/ sink.

Not ported: the rendered comparison images of the tail, early stopping,
preemption, the profiler and multi-device runs.
"""
from __future__ import annotations

import math
import os
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..models.gen_nerf import GenNerf
from ..predict import reconstruct
from ..tsdf.tsdf import TSDF
from .checkpoints import CheckpointManager, load_checkpoint, resolve_checkpoint
from .loggers import CSVLogger, LocalWriter
from .state import lr_for_epoch, set_learning_rate
from .step import batch_to_device, eval_step, train_step


class Trainer:
    def __init__(self, model: GenNerf, optimizer: torch.optim.Optimizer,
                 generator: torch.Generator, out_dir: Optional[str] = None,
                 max_epochs: int = 1, log_every_n_steps: int = 50,
                 check_val_every_n_epoch: int = 1,
                 checkpoints: Optional[CheckpointManager] = None):
        """`generator` supplies every train step's draws, a second generator
        seeded with its initial seed + 1 the validation draws; with
        `out_dir`, metrics go to out_dir/metrics.csv, the validation tail's
        files to out_dir/local/ and checkpoints through `checkpoints`
        (default: every epoch kept in out_dir/checkpoints/)."""
        self.model, self.optimizer, self.generator = model, optimizer, generator
        self.val_generator = torch.Generator(device=generator.device).manual_seed(
            generator.initial_seed() + 1)
        self.max_epochs = max_epochs
        self.log_every_n_steps = log_every_n_steps
        self.check_val_every_n_epoch = check_val_every_n_epoch
        self.logger = CSVLogger(out_dir, name="") if out_dir else None
        self.local = LocalWriter(out_dir) if out_dir else None
        if checkpoints is None and out_dir:
            checkpoints = CheckpointManager(os.path.join(out_dir, "checkpoints"))
        self.ckpt = checkpoints
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
            val_metrics = None
            if val_loader and (epoch + 1) % self.check_val_every_n_epoch == 0:
                val_metrics = self.validate(val_loader)
                self._log(val_metrics)
            if self.ckpt is not None:
                self.ckpt.save(epoch, self.global_step, self.model, self.optimizer,
                               self.generator, self.val_generator, metrics=val_metrics)
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

    def validate(self, loader: Iterable[Dict], mode: str = "val") -> Dict[str, float]:
        """The eval metrics averaged over the loader's batches, keys
        prefixed `{mode}_`, drawn from the validation generator; then the
        reconstruction tail on the last batch (see the module docstring)."""
        device = next(self.model.parameters()).device
        sums: Dict[str, torch.Tensor] = {}
        count = 0
        last = None
        for batch in loader:
            last = batch_to_device(batch, device)
            for k, v in eval_step(self.model, last, self.val_generator).items():
                sums[k] = v if k not in sums else sums[k] + v
            count += 1
        out = {f"{mode}_{k}": float(v) / max(count, 1) for k, v in sums.items()}
        if last is not None:
            out.update(self._reconstruction_tail(last, mode))
        return out

    def _reconstruction_tail(self, batch: Dict[str, torch.Tensor], mode: str) -> Dict[str, float]:
        """Reconstruct batch element 0 at its ground truth's grid (the
        config's voxel_dim_test without one); returns the unmasked TSDF L1
        against the ground truth and writes both volumes and meshes to the
        local sink."""
        cfg = self.model.cfg
        key = "vol_%02d_tsdf" % int(cfg.voxel_size * 100)
        trgt = batch[key][0, 0].cpu().numpy() if key in batch else None
        vol = reconstruct(self.model, batch["projection"][0], batch["image"][0],
                          batch["depth"][0], trgt.shape if trgt is not None else None,
                          generator=self.val_generator).cpu()
        origin = torch.zeros(1, 3)
        out, tsdfs = {}, {"pred": TSDF(cfg.voxel_size, origin, vol)}
        if trgt is not None:
            out[f"{mode}_recon_tsdf_l1"] = float(np.abs(vol.numpy() - trgt).mean())
            tsdfs["trgt"] = TSDF(cfg.voxel_size, origin, torch.from_numpy(trgt))
        if self.local is not None:
            for name, tsdf in tsdfs.items():
                self.local.log_tsdf(tsdf, f"{mode}_tsdf/{mode}_{name}_tsdf")
                self.local.log_mesh(tsdf.get_mesh(), f"{mode}_mesh/{mode}_{name}_mesh")
        return out

    def test(self, loader: Iterable[Dict]) -> Dict[str, float]:
        """The validation pass (with its reconstruction tail) over a test
        loader, keys prefixed `test_`, logged at the current step."""
        metrics = self.validate(loader, mode="test")
        self._log(metrics)
        return metrics


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
