"""Training checkpoints in the port's own format (the reference writes orbax
checkpoints, which reach the port as a params npz; ROADMAP queue 1).

A checkpoint is one `torch.save` file holding the model and optimizer
state dicts, the epoch just finished, the global step and the states of
the step generator and the validation generator, so a resumed run draws
what the uninterrupted run would have drawn. `CheckpointManager` writes
one file per epoch plus `last.pt`.
"""
from __future__ import annotations

import os
from typing import Optional

import torch


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
    device = next(model.parameters()).device
    state = torch.load(path, map_location=device, weights_only=True)
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


class CheckpointManager:
    """epoch_XXXX.pt for every epoch and last.pt in one directory."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def save(self, epoch: int, step: int, model, optimizer, generator=None,
             val_generator=None) -> str:
        path = os.path.join(self.directory, f"epoch_{epoch:04d}.pt")
        for p in (path, os.path.join(self.directory, "last.pt")):
            save_checkpoint(p, model, optimizer, epoch, step, generator, val_generator)
        return path
