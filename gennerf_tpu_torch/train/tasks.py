"""The two model families behind one interface (counterpart of
gennerf_tpu/train/tasks.py), and the precision surface.

A task names, for its family: the config and model classes, `build`
(the model of a config, GenNerf with its config's teacher), the metric
the trainer's finite check reads
(`loss_key`: GenNerf's `combined`, VoxelNet's summed `tsdf_loss`), and the
flax params mapping both ways. The steps (`train.step.train_step`,
`eval_step`) and `predict.reconstruct` take either family's model.

Precision: `dtype_for_precision` maps trainer.precision onto the model's
compute dtype. Under bf16-mixed the model computes in bfloat16 where flax
does (explicit casts in each module, not torch.autocast, whose casts fall
elsewhere); parameters, running statistics, the volume accumulator and
the losses stay float32. Both families take either precision.
"""
from __future__ import annotations

from typing import Callable, Union

import torch

from ..models.config import GenNerfConfig, VoxelNetConfig, config_from_dict
from ..models.gen_nerf import GenNerf
from ..models.teacher import make_teacher
from ..models.voxel_net import VoxelNet
from ..utils.port_params import (
    gen_nerf_npz_tree, gen_nerf_params_from_flax, voxel_net_npz_tree, voxel_net_params_from_flax,
)


def dtype_for_precision(precision) -> torch.dtype:
    """trainer.precision -> the model's compute dtype: '32-true', 32 or None
    -> float32; 'bf16-mixed' or '16-mixed' -> bfloat16 (fp16 maps to bf16,
    as in the JAX package: no loss scaling); anything else raises ValueError."""
    if precision in (None, 32, "32", "32-true", "32-mixed", "f32", "float32"):
        return torch.float32
    if precision in (16, "16", "bf16", "bf16-mixed", "bf16-true", "16-mixed", "16-true",
                     "bfloat16"):
        return torch.bfloat16
    raise ValueError(f"unsupported trainer.precision {precision!r}")


class Task:
    name: str
    config_cls: type
    model_cls: type  # model_cls(cfg, dtype=...): float32 or bfloat16
    loss_key: str
    params_from_flax: Callable
    npz_tree: Callable
    build: Callable  # build(cfg, dtype): the model of a config


class GenNerfTask(Task):
    name = "GenNerf"
    config_cls, model_cls = GenNerfConfig, GenNerf
    loss_key = "combined"
    params_from_flax = staticmethod(gen_nerf_params_from_flax)
    npz_tree = staticmethod(gen_nerf_npz_tree)

    @staticmethod
    def build(cfg: GenNerfConfig, dtype: torch.dtype = torch.float32) -> GenNerf:
        """GenNerf with make_teacher(cfg.teacher); under use_auxiliary the
        teacher's feature_dim must be encoder.auxiliary_dim (ValueError)."""
        teacher = make_teacher(cfg.teacher)
        if cfg.encoder.use_auxiliary and teacher is not None \
                and cfg.encoder.auxiliary_dim != teacher.feature_dim:
            raise ValueError(f"encoder.auxiliary_dim {cfg.encoder.auxiliary_dim} must equal "
                             f"teacher.feature_dim {teacher.feature_dim}")
        return GenNerf(cfg, dtype=dtype, teacher=teacher)


class VoxelNetTask(Task):
    name = "VoxelNet"
    config_cls, model_cls = VoxelNetConfig, VoxelNet
    build = staticmethod(VoxelNet)
    loss_key = "tsdf_loss"
    params_from_flax = staticmethod(voxel_net_params_from_flax)
    npz_tree = staticmethod(voxel_net_npz_tree)


TASKS = {t.name: t for t in (GenNerfTask, VoxelNetTask)}


def task_for(model_or_cfg: Union[torch.nn.Module, dict, GenNerfConfig, VoxelNetConfig]) -> type:
    """The task of a model, a config dataclass or a model config dict
    (its `type`, default GenNerf, as the JAX make_task)."""
    for task in TASKS.values():
        if isinstance(model_or_cfg, (task.model_cls, task.config_cls)):
            return task
    if isinstance(model_or_cfg, dict):
        kind = model_or_cfg.get("type", "GenNerf")
        if kind in TASKS:
            return TASKS[kind]
        raise NotImplementedError(f"model type {kind}")
    raise TypeError(f"no task for {type(model_or_cfg).__name__}")


def model_config(model_cfg: Union[dict, GenNerfConfig, VoxelNetConfig]):
    """The config dataclass of a model config dict (or the dataclass itself)."""
    if isinstance(model_cfg, dict):
        return config_from_dict(task_for(model_cfg).config_cls, model_cfg)
    return model_cfg
