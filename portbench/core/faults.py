"""Faults planted under the timed path, to see the comparison that decides
`correct` come out false: the CPU tests plant each on a tiny run, and
`portbench.calibrate --fault` reads it on the card at the cell's size.
Each replaces one function of core/port.py while it is active."""
from __future__ import annotations

import contextlib

import torch

from . import port


def _answer_altered(real):
    def reconstruct(model, scene, sel, start):
        vol = real(model, scene, sel, start).clone()
        vol[vol.shape[0] // 2] *= 0.5  # one x-slab of the answer halved where it is made
        return vol
    return reconstruct


def _state_unchanged(real):
    def train_step(model, optimizer, batch, draws):
        saved = [p.detach().clone() for p in model.parameters()]
        out = real(model, optimizer, batch, draws)
        with torch.no_grad():
            for p, s in zip(model.parameters(), saved):
                p.copy_(s)
        return out
    return train_step


def _half_batch(real):
    def train_step(model, optimizer, batch, draws):
        B = batch["depth"].shape[0]
        half = {k: v[:B // 2] for k, v in batch.items()}
        rows = {k: (v[:v.shape[0] // 2] if v is not None else None) for k, v in draws.items()}
        return real(model, optimizer, half, rows)
    return train_step


FAULTS = {"answer_altered": ("reconstruct", _answer_altered),
          "state_unchanged": ("train_step", _state_unchanged),
          "half_batch": ("train_step", _half_batch)}


@contextlib.contextmanager
def planted(name: str):
    attr, make = FAULTS[name]
    real = getattr(port, attr)
    setattr(port, attr, make(real))
    try:
        yield
    finally:
        setattr(port, attr, real)
