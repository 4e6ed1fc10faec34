"""The benchmark's one door into the program, gennerf_tpu_torch: build a
model of a configuration with the benchmark's weights, reconstruct a
scene, take a training step. Everything else under portbench/ leaves the
program alone, and the references never come here.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from .weights import make_weights


def build(model_cfg: dict, precision: str, device, seed: int, train: bool = False):
    """(model, weights): the program's model of `model_cfg` computing in
    `precision` on `device`, loaded with the benchmark's weights from
    `seed` (the dict returned, which the reference reads too)."""
    from gennerf_tpu_torch.train.tasks import dtype_for_precision, model_config, task_for

    cfg = model_config(model_cfg)
    with torch.device(device):
        model = task_for(cfg).build(cfg, dtype_for_precision(precision))
    model = model.to(device)
    weights = make_weights(model, seed, device)
    model.load_state_dict(weights, strict=True)
    return (model.train() if train else model.eval()), weights


def reconstruct(model, scene: Dict[str, torch.Tensor], sel: torch.Tensor,
                start: torch.Tensor) -> torch.Tensor:
    """`predict.reconstruct` of one scene's frames with the injected encoder
    draws: the (nx, ny, nz) f32 volume on the card."""
    from gennerf_tpu_torch.predict import reconstruct as program_reconstruct

    return program_reconstruct(model, scene["projection"], scene["image"], scene["depth"],
                               sel=sel, start=start)


def make_optimizer(model, model_cfg: dict):
    """The program's Adam of the configuration (train.state.make_optimizer)."""
    from gennerf_tpu_torch.train.state import make_optimizer as program_optimizer
    from gennerf_tpu_torch.train.tasks import model_config

    return program_optimizer(model.parameters(), model_config(model_cfg).optimizer)


def train_step(model, optimizer, batch: Dict[str, torch.Tensor],
               draws: Dict[str, Optional[torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """`train.step.train_step` on one batch with the injected draws;
    returns its detached metrics (device tensors)."""
    from gennerf_tpu_torch.train.step import StepDraws, train_step as program_step

    return program_step(model, optimizer, batch, None, StepDraws(**draws))


def step_loss(metrics: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The loss a step backpropagated, from its metrics."""
    return metrics["combined"] if "combined" in metrics else metrics["tsdf_loss"]


def capture_encoder_points(model, store: dict):
    """A forward pre-hook on the encoder's PointNet keeping its input, the
    sparse points the presample and FPS picked (normalized as the planes
    see them), in store["points"]; returns the hook's handle."""
    def hook(_module, args):
        store["points"] = args[0].detach()

    return model.pointnet.register_forward_pre_hook(hook)


def adam_first_moments(model, optimizer) -> Dict[str, torch.Tensor]:
    """{parameter name: a copy of Adam's exp_avg}."""
    return {name: optimizer.state[p]["exp_avg"].detach().clone()
            for name, p in model.named_parameters() if p in optimizer.state}


def state_copy(model) -> Dict[str, torch.Tensor]:
    """A copy of the model's floating-point state (parameters, running statistics)."""
    return {k: v.detach().clone() for k, v in model.state_dict().items()
            if v.is_floating_point()}

