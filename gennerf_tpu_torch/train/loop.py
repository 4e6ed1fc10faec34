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
|pred - target| over that grid, and with a logger the two TSDFs (.npz)
and their meshes (.ply, empty ones too) go to its local/ sink.

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

The harness around the steps, as the reference's `Trainer`:
- batch limits (`limit_{train,val,test}_batches`, `batch_limit`): an int
  counts batches, a float in [0, 1] is a share of a sized loader (rounded
  up; 1.0 is everything); a pass pulls one batch past its limit before it
  stops, as the reference's loop does, so the loaders' item serials move
  alike; the reconstruction tail takes the last batch taken;
- early stopping on a validation metric (`early_stopping_monitor`,
  `_patience`, `_mode`), counted from epoch `min_epochs - 1` on; the
  stopping epoch's checkpoint is saved before the loop ends;
- under `save_on_preempt`, a SIGTERM handler (installed from the main
  thread only, the previous one restored when `fit` returns): at the next
  step boundary the current epoch is saved without metrics and `fit`
  returns with `preempted` set; a resumed run continues at the next epoch;
- with `profile_dir`, a torch.profiler window (CPU, and CUDA on the card)
  from global step 1 to step 1 + `profile_steps`, exported as a Chrome
  trace into `profile_dir` (at the end of `fit` if the run stops inside
  the window); beside the operators and kernels it carries the program's
  spans (utils/spans.py): each step's `gennerf.step` and inside it
  `gennerf.forward` (with `gennerf.encode`, and VoxelNet's
  `gennerf.refine`), `gennerf.backward`, `gennerf.allreduce` and
  `gennerf.optimizer`, each on the host and, on the card, as the device's
  range of the same name;
- the callbacks (train/callbacks.py): the parameter table at fit start
  (`model_summary_depth`), the progress line (`progress_bar`), and
  `clear_cache` at train start and around each validation;
- logging through a `MetricsLogger` (the `logger` config group; CSV by
  default) beside the run's own out_dir/metrics.csv, whose rows carry the
  step timings; the hyperparameters of `config_snapshot` at fit start;
  the tail's volumes to the local sink, its meshes and the rendered
  comparison images (`_log_rendered_images`: an overview and up to two
  input views, target beside prediction) to every backend that takes
  them. The reference treats a failing tail as best-effort logging and
  warns; here it raises.

More than one rank (parallel/; the process group joined by the CLI through
`parallel.platform.select_platform`): each rank trains on its rows of
every global batch (a rank-aware loader's batches, or `shard_batch` of a
global one; a final partial batch runs whole on every rank) and the steps
make the losses, gradients, metrics and BatchNorm statistics global, so
the run computes what one process computes at the same global batch. The
console logger, the loggers, the CSV, the progress line, the profiler,
the checkpoints and the reconstruction tail act on rank 0, with a barrier
after each write (the tail's metrics and the validation generator's state
go from rank 0 to the others); the preempt flag is agreed at every step
boundary (any rank's SIGTERM stops every rank after the same step) and
the early-stopping decision is rank 0's. A resume reads the same file on
every rank. With `prefetch_batches` > 0 a background thread takes the
next batches from the loader and uploads them to the device while the
step runs (parallel.mesh.prefetch_shard; 0: the synchronous path). A full
pass pulls what the synchronous pass pulls; a pass abandoned after c
batches has pulled at most c + prefetch_batches + 1, whatever the
threads' timing, and pulls none after.
"""
from __future__ import annotations

import contextlib
import itertools
import math
import os
import signal
import threading
import time
import warnings
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..parallel import distributed
from ..parallel.mesh import prefetch_shard, shard_batch
from ..parallel.platform import is_rank0
from ..predict import reconstruct
from ..tsdf.tsdf import TSDF
from .callbacks import ProgressBar, clear_device_caches, summarize_params
from .checkpoints import CheckpointManager, load_checkpoint, resolve_checkpoint
from .loggers import CSVLogger, MetricsLogger, get_logger, log_hyperparameters
from .state import lr_for_epoch, set_learning_rate
from .step import batch_to_device, eval_step, train_step
from .tasks import dtype_for_precision, task_for


# trainer keys: ported into the port's Trainer, or accepted (no result on
# one card depends on them)
PORTED_TRAINER_KEYS = ("max_epochs", "min_epochs", "log_every_n_steps",
                       "check_val_every_n_epoch", "gradient_clip_val", "precision",
                       "num_sanity_val_steps", "limit_train_batches", "limit_val_batches",
                       "limit_test_batches", "profile_dir", "profile_steps",
                       "early_stopping_monitor", "early_stopping_patience",
                       "early_stopping_mode", "save_on_preempt", "model_summary_depth",
                       "progress_bar", "clear_cache", "prefetch_batches")
# the platform keys (parallel.platform.select_platform reads them: the
# process group, this rank's device) and deterministic
ACCEPTED_TRAINER_KEYS = ("accelerator", "devices", "deterministic", "num_slices", "num_nodes",
                         "coordinator_address", "node_rank")
PORTED_CALLBACKS = ("model_checkpoint", "early_stopping", "rich_progress_bar", "clear_cache",
                    "model_summary")
EARLY_STOPPING_KEYS = ("early_stopping_monitor", "early_stopping_patience",
                       "early_stopping_mode")


def trainer_options(trainer_cfg: dict, callbacks_cfg: Optional[dict] = None) -> dict:
    """The Trainer settings of a config's `trainer` and `callbacks` groups:
    the ported trainer keys (gradient_clip_val is the optimizer's), early
    stopping from callbacks.early_stopping {monitor, patience, mode}
    merged with trainer.early_stopping_* (the trainer keys win, as in the
    reference's CLI), model_summary_depth from callbacks.model_summary
    (its max_depth, 1 by default), progress_bar from
    callbacks.rich_progress_bar and clear_cache from callbacks.clear_cache
    (a trainer key of the same name wins), prefetch_batches (2 by
    default, the JAX Trainer's). The platform keys (devices, num_nodes,
    num_slices, accelerator) are select_platform's. Warns about a key the
    reference's Trainer does not know."""
    trainer_cfg, callbacks_cfg = dict(trainer_cfg or {}), dict(callbacks_cfg or {})
    unknown = sorted(set(trainer_cfg) - set(PORTED_TRAINER_KEYS + ACCEPTED_TRAINER_KEYS))
    unknown += sorted(f"callbacks.{k}" for k in set(callbacks_cfg) - set(PORTED_CALLBACKS))
    if unknown:
        warnings.warn(f"ignoring unknown trainer option(s): {unknown}")
    es = callbacks_cfg.get("early_stopping") or {}
    summary = callbacks_cfg.get("model_summary")
    options = {
        "max_epochs": int(trainer_cfg.get("max_epochs", 10)),
        "min_epochs": int(trainer_cfg.get("min_epochs", 1)),
        "log_every_n_steps": int(trainer_cfg.get("log_every_n_steps", 50)),
        "check_val_every_n_epoch": int(trainer_cfg.get("check_val_every_n_epoch", 1)),
        "num_sanity_val_steps": int(trainer_cfg.get("num_sanity_val_steps", 2)),
        "precision": trainer_cfg.get("precision", "32-true"),
        "gradient_clip_val": trainer_cfg.get("gradient_clip_val"),
        "limit_train_batches": trainer_cfg.get("limit_train_batches"),
        "limit_val_batches": trainer_cfg.get("limit_val_batches"),
        "limit_test_batches": trainer_cfg.get("limit_test_batches"),
        "profile_dir": trainer_cfg.get("profile_dir"),
        "profile_steps": int(trainer_cfg.get("profile_steps", 5)),
        "early_stopping_monitor": es.get("monitor"),
        "early_stopping_patience": int(es.get("patience", 3)),
        "early_stopping_mode": es.get("mode", "min"),
        "save_on_preempt": bool(trainer_cfg.get("save_on_preempt", True)),
        "model_summary_depth": (summary.get("max_depth", 1) if isinstance(summary, dict)
                                else (1 if summary else None)),
        "progress_bar": bool(callbacks_cfg.get("rich_progress_bar")),
        "clear_cache": bool(callbacks_cfg.get("clear_cache")),
        "prefetch_batches": int(trainer_cfg.get("prefetch_batches", 2)),
    }
    options.update({k: trainer_cfg[k] for k in EARLY_STOPPING_KEYS + (
        "model_summary_depth", "progress_bar", "clear_cache") if k in trainer_cfg})
    return options


def batch_limit(limit, loader) -> Optional[int]:
    """The largest number of batches a pass takes from `loader` under a
    limit_*_batches value (None: all). An int is a count; a float in
    [0, 1] a share of the loader's length, rounded up (1.0: all); another
    float raises ValueError; a loader without a length warns and runs all
    its batches."""
    if limit is None:
        return None
    if isinstance(limit, int) and not isinstance(limit, bool):
        return limit
    limit = float(limit)
    if not 0.0 <= limit <= 1.0:
        raise ValueError(f"fractional batch limit must be in [0, 1], got {limit}")
    if limit == 1.0:
        return None
    try:
        n = len(loader)
    except TypeError:
        warnings.warn(f"fractional batch limit {limit} needs a sized loader; running all batches")
        return None
    return math.ceil(limit * n)


class Trainer:
    def __init__(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                 generator: torch.Generator, out_dir: Optional[str] = None,
                 max_epochs: int = 1, log_every_n_steps: int = 50,
                 check_val_every_n_epoch: int = 1,
                 checkpoints: Optional[CheckpointManager] = None, precision=None,
                 num_sanity_val_steps: int = 2, min_epochs: int = 1,
                 limit_train_batches=None, limit_val_batches=None, limit_test_batches=None,
                 early_stopping_monitor: Optional[str] = None, early_stopping_patience: int = 3,
                 early_stopping_mode: str = "min", save_on_preempt: bool = True,
                 profile_dir: Optional[str] = None, profile_steps: int = 5,
                 model_summary_depth: Optional[int] = None, progress_bar: bool = False,
                 clear_cache: bool = False, logger: Optional[MetricsLogger] = None,
                 prefetch_batches: int = 2):
        """`generator` supplies every train step's draws, a second generator
        seeded with its initial seed + 1 the validation draws; with
        `out_dir`, metrics go to out_dir/metrics.csv and to `logger`
        (default: a MetricsLogger of out_dir, the CSV backend and the
        local/ sink), checkpoints through `checkpoints` (default: every
        epoch kept in out_dir/checkpoints/). With `precision`, a model
        computing in another dtype raises ValueError.
        `num_sanity_val_steps` validation batches go through the eval step
        before the first epoch and on resume, as in the reference. The
        harness options are the reference Trainer's (module docstring).
        In a process group, the files and the console are rank 0's."""
        self.model, self.optimizer, self.generator = model, optimizer, generator
        self.task = task_for(model)
        if precision is not None and dtype_for_precision(precision) != model.dtype:
            raise ValueError(f"trainer.precision={precision!r} maps to "
                             f"{dtype_for_precision(precision)}, but the {self.task.name} "
                             f"computes in {model.dtype}")
        if early_stopping_mode not in ("min", "max"):
            raise ValueError(f"early_stopping_mode must be 'min' or 'max', "
                             f"got {early_stopping_mode!r}")
        self.val_generator = torch.Generator(device=generator.device).manual_seed(
            generator.initial_seed() + 1)
        self.max_epochs, self.min_epochs = max_epochs, min_epochs
        self.log_every_n_steps = log_every_n_steps
        self.check_val_every_n_epoch = check_val_every_n_epoch
        self.num_sanity_val_steps = num_sanity_val_steps
        self.limit_train_batches = limit_train_batches
        self.limit_val_batches = limit_val_batches
        self.limit_test_batches = limit_test_batches
        self.early_stopping_monitor = early_stopping_monitor
        self.early_stopping_patience = early_stopping_patience
        self.early_stopping_mode = early_stopping_mode
        self.save_on_preempt = bool(save_on_preempt)
        self.preempted = False
        self.profile_dir, self.profile_steps = profile_dir, profile_steps
        self.profile_trace: Optional[str] = None
        self._profiler = None
        self.model_summary_depth = model_summary_depth
        self.rank0 = is_rank0()
        self.progress = ProgressBar(enabled=progress_bar and self.rank0)
        self.clear_cache = bool(clear_cache)
        self.prefetch_batches = int(prefetch_batches)
        self.log = get_logger()
        self.csv = CSVLogger(out_dir, name="") if out_dir and self.rank0 else None
        self.logger = None if not self.rank0 else logger if logger is not None else (
            MetricsLogger(out_dir) if out_dir else None)
        if checkpoints is None and out_dir:
            checkpoints = CheckpointManager(os.path.join(out_dir, "checkpoints"))
        self.ckpt = checkpoints
        self.global_step = 0
        self.metrics: Dict[str, float] = {}
        # per train step: host ms blocked on the loader, then ms of the step
        # (upload, forward, backward, optimizer) on the device's stream;
        # filled when the host next logs
        self.timings: List[Dict[str, float]] = []
        # per epoch run: host seconds from its first batch to its checkpoint
        self.epoch_seconds: List[float] = []
        self._pending: List[Tuple[float, object, object]] = []
        # the last logged train row, and this epoch's (the progress line's)
        self._last_row: Dict[str, float] = {}
        self._shown: Dict[str, float] = {}

    def _log(self, metrics: Dict[str, float]) -> None:
        self.metrics.update(metrics)
        for logger in (self.csv, self.logger):
            if logger is not None:
                logger.log_metrics(metrics, self.global_step)

    def fit(self, train_loader: Iterable[Dict], val_loader: Iterable[Dict] = (),
            ckpt_path: Optional[str] = None,
            config_snapshot: Optional[dict] = None) -> Dict[str, float]:
        """Train to max_epochs over `train_loader` (iterated once an epoch;
        batches of numpy arrays or tensors); with `ckpt_path` (a checkpoint,
        or a directory holding last.pt) continue after the epoch it saved;
        `config_snapshot` (the composed config) goes to the loggers as the
        run's hyperparameters. Returns the last logged metrics."""
        device = next(self.model.parameters()).device
        if next(iter(train_loader), None) is None:
            raise ValueError("the train loader yielded no batches")
        if distributed.is_multiprocess():
            self.log.info(f"rank {distributed.process_index()} of "
                          f"{distributed.process_count()} ({distributed.backend()})")
        n_params = sum(p.numel() for p in self.model.parameters())
        self.log.info(f"{self.task.name}: {n_params:,} params on {device}")
        if self.model_summary_depth is not None:
            self.log.info("model summary:\n"
                          + summarize_params(self.model, self.model_summary_depth))
        if config_snapshot is not None and self.logger is not None:
            log_hyperparameters(config_snapshot, self.model, self.logger)
        start_epoch = 0
        if ckpt_path:
            info = load_checkpoint(resolve_checkpoint(ckpt_path), self.model, self.optimizer,
                                   self.generator, self.val_generator)
            start_epoch, self.global_step = info["epoch"] + 1, info["step"]
            self.log.info(f"resumed from {ckpt_path} at epoch {start_epoch}")
        if self.num_sanity_val_steps:
            with self._batches(val_loader, device, self.num_sanity_val_steps) as batches:
                for i, (_, batch, split) in enumerate(batches):
                    if i >= self.num_sanity_val_steps:
                        break
                    eval_step(self.model, batch, self.val_generator, **_sharded(split))
        previous = None
        if self.save_on_preempt and threading.current_thread() is threading.main_thread():
            previous = (signal.signal(signal.SIGTERM, self._on_sigterm),)
        try:
            return self._fit_loop(train_loader, val_loader, start_epoch, device)
        finally:
            if previous is not None:
                signal.signal(signal.SIGTERM, previous[0])
            if self._profiler is not None:
                self._stop_profiler(device)

    @contextlib.contextmanager
    def _batches(self, loader, device: torch.device, limit: Optional[int]):
        """The (raw, device batch, sharded) triples of a pass over `loader`
        (this rank's rows, `local_rows`), at most `limit` + 1 pulled from
        the loader, as the synchronous pass pulls (None: all), uploaded
        `prefetch_batches` ahead on a background thread; closing the
        context releases that thread."""
        source = loader if limit is None else itertools.islice(loader, limit + 1)
        gen = prefetch_shard(source, device, self.prefetch_batches,
                             lambda b, d: batch_to_device(local_rows(b)[0], d))
        try:
            yield ((raw, staged, local_rows(raw)[1]) for raw, staged in gen)
        finally:
            gen.close()

    def _save(self, epoch: int, metrics) -> None:
        """The epoch's checkpoint, written by rank 0; the other ranks wait
        for it and read the ranking."""
        if self.ckpt is None:
            return
        if self.rank0:
            self.ckpt.save(epoch, self.global_step, self.model, self.optimizer,
                           self.generator, self.val_generator, metrics=metrics)
        if distributed.is_multiprocess():
            distributed.barrier()
            if not self.rank0:
                self.ckpt.refresh()

    def _on_sigterm(self, signum, frame) -> None:
        self.preempted = True
        self.log.info("SIGTERM: checkpointing at the next step boundary, then exiting")

    def _fit_loop(self, train_loader, val_loader, start_epoch: int,
                  device: torch.device) -> Dict[str, float]:
        cfg = self.model.cfg
        best_monitor, stale_epochs, stop = None, 0, False
        batches_per_epoch = None
        if self.clear_cache:
            clear_device_caches(device, self.log, "train start")
        for epoch in range(start_epoch, self.max_epochs):
            t_epoch = time.perf_counter()
            lr = lr_for_epoch(cfg.optimizer, cfg.scheduler, epoch)
            set_learning_rate(self.optimizer, lr)
            metrics = None  # the last step's, not logged yet
            self._shown = {}
            limit = batch_limit(self.limit_train_batches, train_loader)
            self.progress.start_epoch(epoch, batches_per_epoch if limit is None
                                      else min(limit, batches_per_epoch or limit))
            step_in_epoch = 0
            with self._batches(train_loader, device, limit) as batches:
                while True:
                    t0 = time.perf_counter()
                    item = next(batches, None)
                    if item is None or (limit is not None and step_in_epoch >= limit):
                        break
                    _, batch, split = item
                    wait_ms = (time.perf_counter() - t0) * 1e3
                    if self.profile_dir and self.global_step == 1 and self.rank0:
                        self._start_profiler(device)
                    begin = _mark(device)
                    metrics = train_step(self.model, self.optimizer, batch, self.generator,
                                         **_sharded(split))
                    self._pending.append((wait_ms, begin, _mark(device)))
                    if self._profiler is not None and self.global_step == 1 + self.profile_steps:
                        self._stop_profiler(device)
                    self.global_step += 1
                    step_in_epoch += 1
                    if self.global_step % self.log_every_n_steps == 0:
                        self._log_step(metrics, lr, epoch)
                        metrics = None
                    self.progress.update(step_in_epoch, self._shown or None)
                    self.preempted = distributed.any_rank(self.preempted)
                    if self.preempted:
                        break
            self.progress.end_epoch()
            batches_per_epoch = step_in_epoch or batches_per_epoch
            if self.preempted:
                if step_in_epoch and self.ckpt is not None:
                    self._save(epoch, None)
                    self.log.info(f"preempted during epoch {epoch} (step {self.global_step}): "
                                  "checkpoint saved; resume to continue at epoch "
                                  f"{epoch + 1}")
                else:
                    self.log.info(f"preempted during epoch {epoch} (step {self.global_step}): "
                                  "no checkpoint written (no completed step or no "
                                  "checkpoint manager)")
                return dict(self.metrics)
            if not step_in_epoch:
                raise ValueError(f"the train loader yielded no batches in epoch {epoch}")
            if metrics is not None:  # an epoch logs at least its last step
                self._log_step(metrics, lr, epoch)
            for k, v in self._last_row.items():
                if k.endswith("_coverage") and v == 0.0:
                    warnings.warn(f"{k} == 0 at epoch {epoch}: its masked loss term trained on "
                                  "nothing (its logged loss of 0.0 is vacuous); check the "
                                  "teacher and validity masks")
            val_metrics = None
            if val_loader and (epoch + 1) % self.check_val_every_n_epoch == 0:
                if self.clear_cache:
                    clear_device_caches(device, self.log, "val start")
                val_metrics = self.validate(val_loader, epoch=epoch)
                if self.clear_cache:
                    clear_device_caches(device, self.log, "val end")
                self._log(val_metrics)
                monitor = self.early_stopping_monitor
                if monitor and monitor not in val_metrics:
                    warnings.warn(f"early-stopping monitor {monitor!r} not in validation metrics "
                                  f"{sorted(val_metrics)}: early stopping is inert this epoch")
                elif monitor and epoch + 1 >= self.min_epochs:
                    value = val_metrics[monitor]
                    sign = 1.0 if self.early_stopping_mode == "min" else -1.0
                    if best_monitor is None or sign * value < sign * best_monitor:
                        best_monitor, stale_epochs = value, 0
                    else:
                        stale_epochs += 1
                        if stale_epochs >= self.early_stopping_patience:
                            self.log.info(f"early stopping: {monitor} stale for {stale_epochs} "
                                          f"validations (best {best_monitor:.5f})")
                            stop = True
                stop = distributed.broadcast_object(stop)
            self._save(epoch, val_metrics)
            self.epoch_seconds.append(time.perf_counter() - t_epoch)
            self.log.info(f"epoch {epoch}: " + ", ".join(
                f"{k}={v:.4f}" for k, v in self._last_row.items())
                + f" ({self.epoch_seconds[-1]:.1f}s)")
            if stop:
                break
        return dict(self.metrics)

    def _start_profiler(self, device: torch.device) -> None:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._profiler = profile(activities=activities)
        self._profiler.start()
        self._profile_first = self.global_step

    def _stop_profiler(self, device: torch.device) -> None:
        """Wait for the card, close the window and export its Chrome trace
        into profile_dir."""
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        prof, self._profiler = self._profiler, None
        prof.stop()
        os.makedirs(self.profile_dir, exist_ok=True)
        self.profile_trace = os.path.join(
            self.profile_dir, f"trace_steps{self._profile_first}-{self.global_step}.json")
        prof.export_chrome_trace(self.profile_trace)
        self.log.info(f"profiler trace written to {self.profile_trace}")

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
        self._last_row = self._shown = row
        self._log({**row, **self.timings[-1], "lr": lr, "epoch": epoch})

    def validate(self, loader: Iterable[Dict], mode: str = "val",
                 epoch: int = 0) -> Dict[str, float]:
        """The eval metrics averaged over the loader's batches (up to its
        batch limit), keys prefixed `{mode}_`, drawn from the validation
        generator; then the reconstruction tail on the last batch taken
        (see the module docstring), its meshes and images logged at step
        `epoch`."""
        device = next(self.model.parameters()).device
        limit = batch_limit(self.limit_test_batches if mode == "test"
                            else self.limit_val_batches, loader)
        sums: Dict[str, torch.Tensor] = {}
        count = 0
        last = None
        with self._batches(loader, device, limit) as batches:
            for _, batch, split in batches:
                if limit is not None and count >= limit:
                    break
                last = batch
                for k, v in eval_step(self.model, last, self.val_generator,
                                      **_sharded(split)).items():
                    sums[k] = v if k not in sums else sums[k] + v
                count += 1
        out = {f"{mode}_{k}": float(v) / max(count, 1) for k, v in sums.items()}
        if last is not None:
            tail = self._reconstruction_tail(last, mode, step=epoch) if self.rank0 else None
            if distributed.is_multiprocess():
                # rank 0's tail moved the validation generator: every rank
                # takes its state (and the tail's metrics)
                state = self.val_generator.get_state()
                tail, state = distributed.broadcast_object((tail, state))
                self.val_generator.set_state(state)
            out.update(tail)
        return out

    def _reconstruction_tail(self, batch: Dict[str, torch.Tensor], mode: str,
                             step: int = 0) -> Dict[str, float]:
        """Reconstruct batch element 0 at its ground truth's grid (the
        config's voxel_dim_test without one); returns the unmasked TSDF L1
        against the ground truth. With a logger, both volumes go to the
        local sink, their meshes to every backend and the rendered
        comparison images after them."""
        cfg = self.model.cfg
        key = "vol_%02d_tsdf" % int(cfg.voxel_size * 100)
        trgt = batch[key][0, 0].cpu().numpy() if key in batch else None
        vol = reconstruct(self.model, batch["projection"][0], batch["image"][0],
                          batch["depth"][0], trgt.shape if trgt is not None else None,
                          generator=self.val_generator).cpu()
        origin = torch.zeros(1, 3)
        pred, out = TSDF(cfg.voxel_size, origin, vol), {}
        if self.logger is not None:
            self.logger.local.log_tsdf(pred, f"{mode}_tsdf/{mode}_pred_tsdf")
            mesh_pred = pred.get_mesh()
            self.logger.log_mesh(f"{mode}_mesh/{mode}_pred_mesh", mesh_pred, step=step)
        if trgt is not None:
            out[f"{mode}_recon_tsdf_l1"] = float(np.abs(vol.numpy() - trgt).mean())
            if self.logger is not None:
                target = TSDF(cfg.voxel_size, origin, torch.from_numpy(trgt))
                self.logger.local.log_tsdf(target, f"{mode}_tsdf/{mode}_trgt_tsdf")
                mesh_trgt = target.get_mesh()
                self.logger.log_mesh(f"{mode}_mesh/{mode}_trgt_mesh", mesh_trgt, step=step)
                self._log_rendered_images(mesh_pred, mesh_trgt, batch, mode, step=step)
        return out

    def _log_rendered_images(self, mesh_pred, mesh_trgt, batch: Dict[str, torch.Tensor],
                             mode: str, b_idx: int = 0, num_logged_frames: int = 2,
                             step: int = 0) -> None:
        """Shaded target | prediction renders: an overview framing the
        target mesh, then the first `num_logged_frames` input views, to
        every image-capable backend and the local PNG sink."""
        from ..utils.visuals import compute_camera_pose, render_comparison

        H, W = batch["image"].shape[-2:]
        intr = batch["intrinsics"][b_idx].cpu().numpy()
        poses = batch["pose"][b_idx].cpu().numpy()
        overview = compute_camera_pose(mesh_trgt, intr[0], W, H)
        self.logger.log_image(f"{mode}_render/overview",
                              render_comparison(mesh_pred, mesh_trgt, intr[0], overview, H, W),
                              step=step)
        for i in range(min(num_logged_frames, poses.shape[0])):
            self.logger.log_image(f"{mode}_render/frame{i}",
                                  render_comparison(mesh_pred, mesh_trgt, intr[i], poses[i], H, W),
                                  step=step)

    def test(self, loader: Iterable[Dict]) -> Dict[str, float]:
        """The validation pass (with its reconstruction tail, under
        limit_test_batches) over a test loader, keys prefixed `test_`,
        logged at the current step."""
        metrics = self.validate(loader, mode="test")
        self._log(metrics)
        return metrics


def local_rows(batch: Dict) -> Tuple[Dict, bool]:
    """(this rank's rows of a batch, whether they are a share of it): a
    rank-aware loader's batch as it is (its `shard` flag), else
    `shard_batch` of the global batch."""
    if "shard" in batch:
        return batch, bool(batch["shard"])
    return shard_batch(batch)


def _sharded(split: bool) -> dict:
    """The steps' keyword for a rank's share of a batch (none for a whole
    batch)."""
    return {"sharded": True} if split else {}


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
