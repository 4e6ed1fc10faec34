"""Optimizer and learning-rate schedule (counterpart of
gennerf_tpu/train/state.py).

The reference's optax chain: an optional global-norm clip, the L2 term
added to the gradient (coupled weight decay), Adam's moments (betas
0.9/0.999, eps 1e-8), and the learning rate set per epoch by StepLR.
torch.optim.Adam with weight_decay adds wd*p to the gradient before the
moments, which is that chain without the clip; `GenNerfAdam` clips first,
with optax's rule.
"""
from __future__ import annotations

from typing import Iterable, Optional

import torch

from ..models.config import OptimizerConfig, SchedulerConfig


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm: float) -> None:
    """optax.clip_by_global_norm in place: when the global norm reaches
    max_norm, each gradient becomes g / norm * max_norm (no epsilon, unlike
    torch's clip_grad_norm_). No host synchronization."""
    grads = list(grads)
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


class GenNerfAdam(torch.optim.Adam):
    """torch Adam (coupled L2) with the optional global-norm clip before it."""

    def __init__(self, params, lr: float, weight_decay: float, clip: Optional[float] = None):
        super().__init__(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
        self.clip = clip

    @torch.no_grad()
    def step(self, closure=None):
        if self.clip:
            clip_by_global_norm_([p.grad for group in self.param_groups
                                  for p in group["params"] if p.grad is not None], float(self.clip))
        return super().step(closure)


def make_optimizer(params: Iterable[torch.nn.Parameter], opt_cfg: OptimizerConfig,
                   gradient_clip_val: Optional[float] = None) -> GenNerfAdam:
    if opt_cfg.type != "Adam":
        raise NotImplementedError(f"optimizer {opt_cfg.type} not supported")
    return GenNerfAdam(params, opt_cfg.lr, opt_cfg.weight_decay, gradient_clip_val)


def lr_for_epoch(opt_cfg: OptimizerConfig, sched_cfg: SchedulerConfig, epoch: int) -> float:
    """StepLR: lr * gamma^(epoch // step_size); 'None' keeps lr."""
    if sched_cfg.type == "StepLR":
        return opt_cfg.lr * sched_cfg.gamma ** (epoch // sched_cfg.step_size)
    if sched_cfg.type in ("None", None):
        return opt_cfg.lr
    raise NotImplementedError(f"scheduler {sched_cfg.type} not supported")


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr
