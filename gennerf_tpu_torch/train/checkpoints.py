"""Training checkpoints in the port's own format (the reference writes orbax
checkpoints, which reach the port as a params npz; ROADMAP queue 1).

A checkpoint is one `torch.save` file holding the model state dict (with
the spatial encoder's BatchNorm running statistics, so a resume restores
them exactly), the optimizer state dict, the epoch just finished, the
global step and the states of the step generator and the validation
generator, so a resumed run draws what the uninterrupted run would have
drawn.

`CheckpointManager` keeps the rule of the JAX package's manager
(gennerf_tpu/train/checkpoints.py): without a `monitor` every epoch is
ranked and the newest `save_top_k` are kept (-1: all); with a monitor an
epoch is ranked only when its metrics hold the monitored value, the best
`save_top_k` by it are kept (`mode` min or max, the earlier epoch first on
a tie), and an epoch without the value only refreshes `last.pt`, which
every epoch writes when `save_last`. The ranking lives in
`checkpoints.json` beside the files, so another process (the predict and
render CLIs) finds the best epoch.
"""
from __future__ import annotations

import json
import os
import pickle
from typing import Dict, Optional

import torch

RANKING_FILE = "checkpoints.json"


def save_checkpoint(path: str, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                    epoch: int, step: int, generator: Optional[torch.Generator] = None,
                    val_generator: Optional[torch.Generator] = None) -> None:
    """Write atomically (a temporary file renamed into place)."""
    state = {"model": model.state_dict(), "optimizer": optimizer.state_dict(),
             "epoch": int(epoch), "step": int(step),
             "generator": None if generator is None else generator.get_state(),
             "val_generator": None if val_generator is None else val_generator.get_state()}
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(state, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, model: torch.nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    generator: Optional[torch.Generator] = None,
                    val_generator: Optional[torch.Generator] = None) -> dict:
    """Restore what `save_checkpoint` wrote into the given objects (tensors
    onto the model's device); returns {'epoch', 'step'}."""
    from ..utils.port_reference import is_reference_checkpoint

    refused = NotImplementedError(
        f"{path} is a reference Lightning checkpoint: resuming its optimizer state is not "
        "ported; start from its weights with --params")
    device = next(model.parameters()).device
    try:
        state = torch.load(path, map_location=device, weights_only=True)
    except pickle.UnpicklingError:  # a Lightning checkpoint pickles foreign classes
        if is_reference_checkpoint(path):
            raise refused from None
        raise
    if "model" not in state and "state_dict" in state:
        raise refused
    model.load_state_dict(state["model"])
    if optimizer is not None:
        optimizer.load_state_dict(state["optimizer"])
    for gen, key in ((generator, "generator"), (val_generator, "val_generator")):
        if gen is not None and state.get(key) is not None:
            gen.set_state(state[key].cpu())
    return {"epoch": state["epoch"], "step": state["step"]}


def resolve_checkpoint(path: str) -> str:
    """A checkpoint file, or the `last.pt` of a checkpoint directory or of
    a training run's output directory (its `checkpoints/`)."""
    for candidate in (path, os.path.join(path, "last.pt"),
                      os.path.join(path, "checkpoints", "last.pt")):
        if os.path.isfile(candidate):
            return candidate
    raise FileNotFoundError(f"no checkpoint at {path}")


def select_checkpoint(path: str):
    """(file, selected_by) for an entry point's `--ckpt`: a file as given
    ('file'); for a checkpoint directory or a run's output directory the
    best monitored epoch (selected_by: the monitor), else the latest
    ('latest')."""
    if os.path.isfile(path):
        return path, "file"
    try:
        manager = CheckpointManager.open(path)
    except FileNotFoundError:
        return resolve_checkpoint(path), "latest"
    file, _, selected_by = manager.best_or_latest()
    return file, selected_by


class CheckpointManager:
    """epoch_XXXX.pt for the kept epochs, last.pt and the ranking in one
    directory (see the module docstring for the retention rule)."""

    def __init__(self, directory: str, save_top_k: int = -1, save_last: bool = True,
                 monitor: Optional[str] = None, mode: str = "min"):
        if mode not in ("min", "max"):
            raise ValueError(f"monitor mode must be 'min' or 'max', got {mode!r}")
        self.directory = os.path.abspath(directory)
        self.save_top_k, self.save_last = int(save_top_k), bool(save_last)
        self.monitor, self.mode = monitor, mode
        # kept epoch -> its monitored value (None without a monitor)
        self.ranked: Dict[int, Optional[float]] = {}
        self.last_epoch: Optional[int] = None
        os.makedirs(self.directory, exist_ok=True)
        self.refresh()

    def refresh(self) -> None:
        """Read the ranking the directory holds (another rank's writes)."""
        path = os.path.join(self.directory, RANKING_FILE)
        if os.path.exists(path):
            with open(path) as f:
                saved = json.load(f)
            if (saved["monitor"], saved["mode"]) != (self.monitor, self.mode):
                raise ValueError(f"{self.directory} ranks by {saved['monitor']!r} "
                                 f"({saved['mode']}), not {self.monitor!r} ({self.mode})")
            self.ranked = {int(k): v for k, v in saved["ranked"].items()}
            self.last_epoch = saved["last_epoch"]

    @classmethod
    def open(cls, path: str) -> "CheckpointManager":
        """The manager of an existing checkpoint directory, or of a training
        run's output directory (its `checkpoints/`), with the monitor and
        mode its ranking was made with."""
        for directory in (path, os.path.join(path, "checkpoints")):
            ranking = os.path.join(directory, RANKING_FILE)
            if os.path.isfile(ranking):
                with open(ranking) as f:
                    saved = json.load(f)
                return cls(directory, saved["save_top_k"], monitor=saved["monitor"],
                           mode=saved["mode"])
        raise FileNotFoundError(f"no {RANKING_FILE} in {path} or {path}/checkpoints")

    def path(self, epoch: int) -> str:
        return os.path.join(self.directory, f"epoch_{epoch:04d}.pt")

    def save(self, epoch: int, step: int, model, optimizer, generator=None,
             val_generator=None, metrics: Optional[Dict[str, float]] = None) -> str:
        """Write the epoch's checkpoint where the rule keeps it, refresh
        last.pt, drop the epochs that left the top k; returns the path of
        the epoch's file, or of last.pt for an epoch that is not ranked."""
        args = (model, optimizer, epoch, step, generator, val_generator)
        ranked = not self.monitor or (metrics is not None and self.monitor in metrics)
        written = os.path.join(self.directory, "last.pt")
        if ranked:
            written = self.path(epoch)
            save_checkpoint(written, *args)
            self.ranked[int(epoch)] = float(metrics[self.monitor]) if self.monitor else None
        if self.save_last or not ranked:
            save_checkpoint(os.path.join(self.directory, "last.pt"), *args)
            self.last_epoch = int(epoch)
        for dropped in set(self.ranked) - set(self._kept()):
            del self.ranked[dropped]
            if os.path.exists(self.path(dropped)):
                os.remove(self.path(dropped))
        self._write_ranking()
        return written

    def _order(self):
        """Ranked epochs, best first: by the monitored value (the earlier
        epoch first on a tie), else the newest first."""
        if not self.monitor:
            return sorted(self.ranked, reverse=True)
        sign = 1.0 if self.mode == "min" else -1.0
        return sorted(self.ranked, key=lambda e: (sign * self.ranked[e], e))

    def _kept(self):
        order = self._order()
        return order if self.save_top_k == -1 else order[:max(self.save_top_k, 1)]

    def _write_ranking(self) -> None:
        path = os.path.join(self.directory, RANKING_FILE)
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"monitor": self.monitor, "mode": self.mode, "save_top_k": self.save_top_k,
                       "ranked": {str(k): v for k, v in sorted(self.ranked.items())},
                       "last_epoch": self.last_epoch}, f, indent=1)
        os.replace(tmp, path)

    def kept_epochs(self):
        """The epochs whose epoch_XXXX.pt is kept, ascending."""
        return sorted(self.ranked)

    def best_epoch(self) -> Optional[int]:
        """The epoch with the best monitored value; None without a monitor
        and None when no epoch was ranked."""
        if not self.monitor or not self.ranked:
            return None
        return self._order()[0]

    def latest_epoch(self) -> Optional[int]:
        epochs = list(self.ranked) + ([self.last_epoch] if self.last_epoch is not None else [])
        return max(epochs) if epochs else None

    def checkpoint_path(self, epoch: int) -> str:
        """The file that holds `epoch`: its epoch file, or last.pt."""
        if epoch in self.ranked:
            return self.path(epoch)
        if epoch == self.last_epoch:
            return os.path.join(self.directory, "last.pt")
        raise FileNotFoundError(f"no checkpoint for epoch {epoch} in {self.directory}")

    def best_or_latest(self):
        """(path, epoch, selected_by) of the best monitored epoch, else of
        the latest ('latest'); raises when the directory holds none."""
        best = self.best_epoch()
        epoch = best if best is not None else self.latest_epoch()
        if epoch is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return self.checkpoint_path(epoch), epoch, self.monitor if best is not None else "latest"

    def restore_best(self, model, optimizer=None) -> dict:
        """Load the best monitored epoch (the latest without one) into
        `model` (and `optimizer`); returns {'epoch', 'step'}."""
        path, _, _ = self.best_or_latest()
        return load_checkpoint(path, model, optimizer)
