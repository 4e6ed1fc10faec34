"""The device and process group of an entry point (counterpart of
gennerf_tpu/parallel/platform.py).

`select_platform(trainer_cfg, device)` reads the trainer config's
`accelerator`, `devices`, `num_nodes` and `num_slices`:
- it joins the process group (parallel/distributed.py) when num_nodes > 1,
  when a launcher's variables are set, or when devices > 1; a run that
  asks for more than one rank without a launcher raises, naming it;
- one rank drives one device, so `devices` is the number of ranks on a
  node (the JAX Trainer's local devices per process, Lightning's
  devices): an int must equal the ranks the launcher started on this node
  (LOCAL_WORLD_SIZE, else world size / num_nodes); 'auto' takes what the
  launcher started;
- `node_rank` is the node's index (Lightning's): a rank's global index is
  node_rank * ranks per node + LOCAL_RANK, and a rank the launcher names
  (RANK) must lie on that node;
- `num_slices` (the TPU pod's DCN axis, parallel/mesh.py) maps onto nodes:
  a slice is a group of world size / num_slices consecutive ranks, and the
  world size must split into equal slices. The all-reduce is one flat
  collective over every rank (NCCL takes its own route within and across
  nodes), so the result is the flat run's, as the JAX hybrid mesh's is;
- it returns this rank's device: cuda:LOCAL_RANK on the card (one card a
  rank), or the CPU when `device` or `accelerator` says so.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch

from . import distributed


def is_rank0() -> bool:
    """The rank-zero gate of loggers, console and artifact writers: True
    unless this process is a non-zero rank of a joined group."""
    return distributed.process_index() == 0


def _int_or_none(value) -> Optional[int]:
    if value in (None, "auto"):
        return None
    return int(value)


def wants_group(trainer_cfg: Dict[str, Any]) -> bool:
    """Whether the trainer config (or a launcher) asks for more than one
    rank."""
    cfg = trainer_cfg or {}
    return (int(cfg.get("num_nodes") or 1) > 1 or (_int_or_none(cfg.get("devices")) or 1) > 1
            or int(cfg.get("num_slices") or 1) > 1 or distributed.launcher_world_size() > 1)


def _process_id(cfg: Dict[str, Any], num_nodes: int) -> Optional[int]:
    """This process's global rank from `trainer.node_rank`, the node's
    index (Lightning's meaning; one rank a card, so a node holds
    world / num_nodes ranks): node_rank * ranks per node + LOCAL_RANK.
    None without node_rank (the launcher's RANK / GENNERF_PROCESS_ID
    serve). Where the launcher names the rank too, it must lie on that
    node (ValueError)."""
    node = _int_or_none(cfg.get("node_rank"))
    if node is None:
        return None
    world = distributed.launcher_world_size()
    per_node = int(os.environ.get("LOCAL_WORLD_SIZE") or max(world // num_nodes, 1))
    named = distributed.launcher_rank()
    if named is not None:
        if named // per_node != node:
            raise ValueError(f"trainer.node_rank={node}: the launcher started rank {named}, "
                             f"which lies on node {named // per_node} ({per_node} a node)")
        return named
    return node * per_node + distributed.local_rank()


def select_platform(trainer_cfg: Dict[str, Any], device=None,
                    backend: Optional[str] = None) -> torch.device:
    """Join the process group when the config or the environment asks for
    more than one rank (module docstring) and return this rank's device.
    `device` (e.g. 'cpu' or 'cuda') names the device type; default: the
    config's accelerator ('cpu' -> CPU, else the card). Raises RuntimeError
    without a launcher, ValueError when devices or num_slices do not fit
    the ranks started, and RuntimeError when CUDA is asked for and absent."""
    cfg = dict(trainer_cfg or {})
    accel = cfg.get("accelerator", "auto")
    kind = torch.device(device).type if device is not None else (
        "cpu" if accel == "cpu" else "cuda")
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to run on the CPU")
    if not wants_group(cfg):
        return torch.device(device) if device is not None else torch.device(kind)
    if not distributed.launcher_env() and not distributed.is_multiprocess():
        raise RuntimeError(
            f"trainer.devices={cfg.get('devices')}, num_nodes={cfg.get('num_nodes')}, "
            f"num_slices={cfg.get('num_slices')} ask for more than one rank: start the run "
            f"with `{distributed.LAUNCHER}` or `torchrun --nproc_per_node=N -m "
            "gennerf_tpu_torch.train ...`")
    rank_device = (torch.device("cuda", distributed.local_rank()) if kind == "cuda"
                   else torch.device("cpu"))
    num_nodes = int(cfg.get("num_nodes") or 1)
    distributed.init_distributed(rank_device, backend=backend,
                                 coordinator_address=cfg.get("coordinator_address"),
                                 process_id=_process_id(cfg, num_nodes))
    world = distributed.process_count()
    if world % num_nodes:
        raise ValueError(f"trainer.num_nodes={num_nodes} does not divide the {world} ranks")
    per_node = int(os.environ.get("LOCAL_WORLD_SIZE") or world // num_nodes)
    devices = _int_or_none(cfg.get("devices"))
    if devices is not None and devices != per_node:
        raise ValueError(f"trainer.devices={devices}: one rank drives one device, and the "
                         f"launcher started {per_node} rank(s) on this node")
    slices = int(cfg.get("num_slices") or 1)
    if world % slices:
        raise ValueError(f"{world} ranks do not split into num_slices={slices} equal slices")
    return rank_device
