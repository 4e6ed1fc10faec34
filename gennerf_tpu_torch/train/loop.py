"""A minimal training loop (counterpart of gennerf_tpu/train/loop.py
`Trainer.fit`) for either model family (its task, train/tasks.py: the
steps take either model, the finite check reads the task's loss key):
epochs over a train loader with the learning rate set per
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
generator; a VoxelNet's finest-scale volume, clamped by the fusion prior
under mask_unobserved), `{mode}_recon_tsdf_l1` is the unmasked mean
|pred - target| over that grid, and with an output directory the two
TSDFs (.npz) and their meshes (.ply, empty ones too) go to its local/ sink.

Given the run's `precision` (trainer.precision), the trainer refuses a
model computing in another dtype than that precision's, the rule the
reference's loop checks for (it warns; the port raises, since a
silently float32 run is not the run the config asks for).

As the reference's `fit`, it first pulls one batch from the train loader
(the reference sizes its state from it), then, before the first epoch
(on resume too), runs the sanity pass: the eval step on the first
`num_sanity_val_steps` validation batches, drawing from the validation
generator, logging and saving nothing. Both move the loaders' item serials
as the reference's do, so the later batches equal the reference's. At each
epoch's end a `*_coverage` metric of exactly 0 (a masked term that trained
on nothing) is warned about.

`trainer_options` reads a config's `trainer` and `callbacks` groups:
every key is ported, accepted (it changes no result on one card) or
raises NotImplementedError; a key the reference's Trainer does not know
is warned about.

Not ported: the rendered comparison images of the tail, early stopping,
batch limits, preemption, the profiler and multi-device runs.
"""
from __future__ import annotations

import math
import os
import time
import warnings
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..predict import reconstruct
from ..tsdf.tsdf import TSDF
from .checkpoints import CheckpointManager, load_checkpoint, resolve_checkpoint
from .loggers import CSVLogger, LocalWriter
from .state import lr_for_epoch, set_learning_rate
from .step import batch_to_device, eval_step, train_step
from .tasks import dtype_for_precision, task_for


# trainer keys: ported into the port's Trainer, accepted (no result on one
# card depends on them), or raising until ported
PORTED_TRAINER_KEYS = ("max_epochs", "log_every_n_steps", "check_val_every_n_epoch",
                       "gradient_clip_val", "precision", "num_sanity_val_steps")
# min_epochs gates only early stopping in the reference, which raises here;
# save_on_preempt acts only on SIGTERM; profile_steps and the node keys act
# only with profile_dir / num_nodes > 1, which raise
ACCEPTED_TRAINER_KEYS = ("accelerator", "devices", "deterministic", "min_epochs",
                         "save_on_preempt", "prefetch_batches", "profile_steps",
                         "model_summary_depth", "progress_bar", "clear_cache",
                         "coordinator_address", "node_rank")
RAISING_TRAINER_KEYS = ("limit_train_batches", "limit_val_batches", "limit_test_batches",
                        "profile_dir", "num_slices", "num_nodes", "early_stopping_monitor",
                        "early_stopping_patience", "early_stopping_mode")
PORTED_CALLBACKS = ("model_checkpoint",)
ACCEPTED_CALLBACKS = ("rich_progress_bar", "clear_cache", "model_summary")


def trainer_options(trainer_cfg: dict, callbacks_cfg: Optional[dict] = None) -> dict:
    """The Trainer settings of a config's `trainer` and `callbacks` groups:
    {max_epochs, log_every_n_steps, check_val_every_n_epoch,
    num_sanity_val_steps, precision, gradient_clip_val (the optimizer's)}.
    Raises NotImplementedError, naming the key, for a non-null
    limit_*_batches or profile_dir, early stopping (callbacks.early_stopping
    or trainer.early_stopping_*), devices, num_slices or num_nodes above 1;
    warns about a key the reference's Trainer does not know."""
    trainer_cfg, callbacks_cfg = dict(trainer_cfg or {}), dict(callbacks_cfg or {})
    bad = [k for k in RAISING_TRAINER_KEYS if k in trainer_cfg and (
        trainer_cfg[k] is not None if k.startswith(("limit_", "profile_", "early_"))
        else int(trainer_cfg[k] or 1) > 1)]
    devices = trainer_cfg.get("devices", "auto")
    if devices not in ("auto", None) and int(devices) > 1:
        bad.append("devices")
    bad += [f"callbacks.{k}" for k in ("early_stopping",) if callbacks_cfg.get(k)]
    if bad:
        raise NotImplementedError(f"gennerf_tpu_torch's trainer does not implement: "
                                  f"{', '.join(bad)}")
    unknown = sorted(set(trainer_cfg) - set(PORTED_TRAINER_KEYS + ACCEPTED_TRAINER_KEYS
                                            + RAISING_TRAINER_KEYS))
    unknown += sorted(f"callbacks.{k}" for k in set(callbacks_cfg) - set(
        PORTED_CALLBACKS + ACCEPTED_CALLBACKS + ("early_stopping",)))
    if unknown:
        warnings.warn(f"ignoring unknown trainer option(s): {unknown}")
    return {
        "max_epochs": int(trainer_cfg.get("max_epochs", 10)),
        "log_every_n_steps": int(trainer_cfg.get("log_every_n_steps", 50)),
        "check_val_every_n_epoch": int(trainer_cfg.get("check_val_every_n_epoch", 1)),
        "num_sanity_val_steps": int(trainer_cfg.get("num_sanity_val_steps", 2)),
        "precision": trainer_cfg.get("precision", "32-true"),
        "gradient_clip_val": trainer_cfg.get("gradient_clip_val"),
    }


class Trainer:
    def __init__(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                 generator: torch.Generator, out_dir: Optional[str] = None,
                 max_epochs: int = 1, log_every_n_steps: int = 50,
                 check_val_every_n_epoch: int = 1,
                 checkpoints: Optional[CheckpointManager] = None, precision=None,
                 num_sanity_val_steps: int = 2):
        """`generator` supplies every train step's draws, a second generator
        seeded with its initial seed + 1 the validation draws; with
        `out_dir`, metrics go to out_dir/metrics.csv, the validation tail's
        files to out_dir/local/ and checkpoints through `checkpoints`
        (default: every epoch kept in out_dir/checkpoints/). With
        `precision`, a model computing in another dtype raises ValueError.
        `num_sanity_val_steps` validation batches go through the eval step
        before the first epoch and on resume, as in the reference."""
        self.model, self.optimizer, self.generator = model, optimizer, generator
        self.task = task_for(model)
        if precision is not None and dtype_for_precision(precision) != model.dtype:
            raise ValueError(f"trainer.precision={precision!r} maps to "
                             f"{dtype_for_precision(precision)}, but the {self.task.name} "
                             f"computes in {model.dtype}")
        self.val_generator = torch.Generator(device=generator.device).manual_seed(
            generator.initial_seed() + 1)
        self.max_epochs = max_epochs
        self.log_every_n_steps = log_every_n_steps
        self.check_val_every_n_epoch = check_val_every_n_epoch
        self.num_sanity_val_steps = num_sanity_val_steps
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
        self._last_row: Dict[str, float] = {}

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
        if next(iter(train_loader), None) is None:
            raise ValueError("the train loader yielded no batches")
        start_epoch = 0
        if ckpt_path:
            info = load_checkpoint(resolve_checkpoint(ckpt_path), self.model, self.optimizer,
                                   self.generator, self.val_generator)
            start_epoch, self.global_step = info["epoch"] + 1, info["step"]
        if self.num_sanity_val_steps:
            for i, batch in enumerate(val_loader):
                if i >= self.num_sanity_val_steps:
                    break
                eval_step(self.model, batch_to_device(batch, device), self.val_generator)
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
            for k, v in self._last_row.items():
                if k.endswith("_coverage") and v == 0.0:
                    warnings.warn(f"{k} == 0 at epoch {epoch}: its masked loss term trained on "
                                  "nothing (its logged loss of 0.0 is vacuous); check the "
                                  "teacher and validity masks")
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
        loss = row[f"train_{self.task.loss_key}"]
        if not math.isfinite(loss):
            raise FloatingPointError(f"loss {loss} at step {self.global_step}")
        self._last_row = row
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
