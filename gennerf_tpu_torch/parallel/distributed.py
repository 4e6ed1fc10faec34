"""The process group and the collectives of data-parallel training
(counterpart of gennerf_tpu/parallel/distributed.py).

One process drives one device (a card, or the CPU), as Lightning's DDP
does; the JAX package instead runs one jit-global program over a mesh of
every process's devices. The port keeps the JAX package's semantics: a run
on N ranks at global batch B computes what one process computes at B.

- `init_distributed` joins `torch.distributed` from the launcher's
  environment: torchrun's RANK / WORLD_SIZE / LOCAL_RANK / MASTER_ADDR /
  MASTER_PORT, or the JAX launcher's GENNERF_COORDINATOR (host:port) /
  GENNERF_NUM_PROCESSES / GENNERF_PROCESS_ID (tools/launch_local.py sets
  both). NCCL for a CUDA device, gloo for the CPU, or the backend named.
  A warm-up all-reduce forms the transport while the ranks are aligned.
- A step runs `sharded()` when its batch holds this rank's rows of the
  global batch. Inside (`active()`), `shard_count()` is the world size and
  the reductions below act, at a world size of 1 too (one rank of a
  joined group runs every collective, so the machinery's cost shows);
  outside (no process group, or a final partial batch that every rank
  runs whole), they are the identity.
- `global_sum(x)`: the sum of x over the ranks. Its backward passes the
  upstream gradient on unchanged: every rank computes the same function
  of the sum (a loss, a global mean), and `all_reduce_gradients` then
  sums the ranks' parameter gradients, which gives the gradient of the
  global value.
- `shared_sum(x)`: the same sum, whose backward all-reduces the upstream
  gradient: for statistics that each rank applies to its own rows
  (BatchNorm), where a rank's upstream gradient holds only its rows'
  share.
- `all_reduce_gradients(params)`: one coalesced all-reduce (sum) of every
  parameter's gradient in a fixed order (per dtype); a missing gradient
  counts as zeros, and stays None where every rank had none.

Note: torch.distributed.nn.functional.all_reduce's backward sums the
upstream gradients over the ranks, which counts a replicated loss N times;
hence the two autograd functions here.
"""
from __future__ import annotations

import contextlib
import datetime
import os
from typing import Iterable, List, Optional

import torch
import torch.distributed as dist

LAUNCHER = "python -m gennerf_tpu_torch.tools.launch_local -n N -- <train arguments>"


class _State:
    device: Optional[torch.device] = None
    sharded: bool = False
    # the group of host-side flags: a gloo group beside an NCCL one, else
    # the default group (None)
    host_group = None


_STATE = _State()


def launcher_env() -> bool:
    """Whether a launcher started this process as one rank of a group."""
    env = os.environ
    return bool(env.get("GENNERF_NUM_PROCESSES") or env.get("WORLD_SIZE"))


def _env_int(*names: str) -> Optional[int]:
    for k in names:
        if os.environ.get(k) not in (None, ""):
            return int(os.environ[k])
    return None


def launcher_world_size() -> int:
    """The world size a launcher's variables name (1 without one)."""
    return _env_int("WORLD_SIZE", "GENNERF_NUM_PROCESSES") or 1


def launcher_rank() -> Optional[int]:
    """The global rank a launcher's variables name (None without one)."""
    return _env_int("RANK", "GENNERF_PROCESS_ID", "SLURM_PROCID")


def local_rank() -> int:
    """This rank's index on its node: LOCAL_RANK (torchrun), else the
    process id of the local launcher (every rank on one host)."""
    value = _env_int("LOCAL_RANK", "GENNERF_PROCESS_ID", "RANK")
    return 0 if value is None else value


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(device=None, backend: Optional[str] = None,
                     coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None, process_id: Optional[int] = None,
                     timeout_s: float = 600.0) -> None:
    """Join the process group as this process's rank (the arguments win
    over the environment); `device` is the rank's device (default
    cuda:LOCAL_RANK when a card is visible, else the CPU). Raises
    RuntimeError when neither the arguments nor the environment name the
    group. A second call in a process that already joined does nothing."""
    if dist.is_initialized():
        return
    env = os.environ
    world = num_processes if num_processes is not None else _env_int(
        "WORLD_SIZE", "GENNERF_NUM_PROCESSES")
    rank = process_id if process_id is not None else launcher_rank()
    coordinator = coordinator_address or env.get("GENNERF_COORDINATOR")
    if coordinator:
        init_method = f"tcp://{coordinator}"
    elif env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        init_method = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    else:
        init_method = None
    if world is None or rank is None or init_method is None:
        raise RuntimeError("more than one rank needs a launcher: start the run with "
                           f"`{LAUNCHER}` or `torchrun --nproc_per_node=N -m "
                           "gennerf_tpu_torch.train ...`")
    if device is None:
        device = (torch.device("cuda", local_rank()) if torch.cuda.is_available()
                  else torch.device("cpu"))
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    backend = backend or default_backend(device)
    kwargs = {}
    if backend == "nccl":
        kwargs["device_id"] = device
    dist.init_process_group(backend, init_method=init_method, world_size=int(world),
                            rank=int(rank), timeout=datetime.timedelta(seconds=timeout_s),
                            **kwargs)
    _STATE.device = device
    if backend != "gloo":
        _STATE.host_group = dist.new_group(backend="gloo")
    _warmup_collectives()


def _warmup_collectives() -> None:
    """One all-reduce over every rank while they are still aligned from
    init, so that the transport forms before the first step's collectives
    (which the ranks reach after uneven set-up work)."""
    x = torch.ones(1, device=_STATE.device)
    dist.all_reduce(x)
    if int(x.item()) != process_count():
        raise RuntimeError(f"warm-up all-reduce gave {x.item()}, expected {process_count()}")


def shutdown() -> None:
    """Leave the process group (if joined)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _STATE.device, _STATE.sharded, _STATE.host_group = None, False, None


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_multiprocess() -> bool:
    return process_count() > 1


def backend() -> Optional[str]:
    return dist.get_backend() if dist.is_initialized() else None


def local_batch_slice(global_batch_size: int, world: Optional[int] = None,
                      rank: Optional[int] = None) -> slice:
    """Rank `rank`'s rows [r*k, (r+1)*k) of a global batch of `world`
    ranks (default: this process in its group); raises ValueError when the
    ranks do not divide it."""
    n = process_count() if world is None else world
    i = process_index() if rank is None else rank
    if global_batch_size % n:
        raise ValueError(f"global batch {global_batch_size} not divisible by {n} processes")
    k = global_batch_size // n
    return slice(i * k, (i + 1) * k)


@contextlib.contextmanager
def sharded(enabled: bool = True):
    """Within: the step's batch is this rank's rows of the global batch,
    so its draws, losses and BatchNorm statistics are global (a no-op
    without a process group)."""
    before = _STATE.sharded
    _STATE.sharded = bool(enabled) and dist.is_initialized()
    try:
        yield
    finally:
        _STATE.sharded = before


def active() -> bool:
    """Whether the current step is a rank's share of a global batch."""
    return _STATE.sharded


def shard_count() -> int:
    """The number of ranks the current step's batch is split over (1
    outside `sharded`)."""
    return process_count() if _STATE.sharded else 1


def shard_index() -> int:
    return process_index() if _STATE.sharded else 0


class _GlobalSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        return g


class _SharedSum(_GlobalSum):
    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the step's ranks, for a value every rank then uses alike
    (module docstring); the identity outside a sharded step."""
    return _GlobalSum.apply(x) if active() else x


def shared_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the step's ranks, for statistics each rank applies to its
    own rows: the backward all-reduces the gradient."""
    return _SharedSum.apply(x) if active() else x


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of x over every rank's elements (x.mean() in one process)."""
    if not active():
        return x.mean()
    return global_sum(x.sum()) / (x.numel() * shard_count())


def global_ratio(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num / max(den, 1) of two scalars summed over the step's ranks (a
    masked mean's sum and count: one all-reduce of both)."""
    if not active():
        return num / torch.clamp(den, min=1.0)
    sums = global_sum(torch.stack([num, den.to(num.dtype)]))
    return sums[0] / torch.clamp(sums[1], min=1.0)


def all_reduce_gradients(params: Iterable[torch.nn.Parameter]) -> None:
    """Sum every parameter's gradient over the step's ranks in one
    all-reduce per gradient dtype, parameters in their given order; a rank
    without a gradient adds zeros, and a parameter no rank has a gradient
    for keeps None. Each parameter's count of ranks holding a gradient
    rides in the first buffer; the host reads the counts only where this
    rank lacks a gradient (otherwise nothing here waits for the device).
    A no-op outside a sharded step."""
    if not active():
        return
    params = [p for p in params if p.requires_grad]
    missing = [i for i, p in enumerate(params) if p.grad is None]
    groups = {}
    for i, p in enumerate(params):
        groups.setdefault(p.dtype, []).append(i)
    counts = None
    for dtype, idx in groups.items():
        parts = [(params[i].grad if params[i].grad is not None
                  else torch.zeros_like(params[i])).reshape(-1) for i in idx]
        if counts is None:
            has = torch.ones(len(params), dtype=dtype, device=params[0].device)
            if missing:
                has[missing] = 0
            parts.append(has)
        flat = torch.cat(parts)
        dist.all_reduce(flat)
        offset = 0
        for i in idx:
            p = params[i]
            n = p.numel()
            p.grad = flat[offset:offset + n].view_as(p).clone() if p.grad is None else (
                p.grad.copy_(flat[offset:offset + n].view_as(p)))
            offset += n
        if counts is None:
            counts = flat[offset:]
    if missing:
        held = counts[missing].tolist()
        for i, c in zip(missing, held):
            if c == 0:
                params[i].grad = None


def all_gather_cat(t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The ranks' tensors (equal shapes) concatenated along `dim` in rank
    order. gloo gathers through host memory."""
    if not is_multiprocess():
        return t
    src = t.contiguous()
    if backend() == "gloo" and src.device.type == "cuda":
        src = src.cpu()
    parts: List[torch.Tensor] = [torch.empty_like(src) for _ in range(process_count())]
    dist.all_gather(parts, src)
    return torch.cat(parts, dim=dim).to(t.device)


def any_rank(flag: bool) -> bool:
    """True on every rank when any rank passes True (a max all-reduce of a
    host tensor over gloo: it waits for no device work)."""
    if not is_multiprocess():
        return bool(flag)
    t = torch.tensor([1.0 if flag else 0.0])
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_STATE.host_group)
    return bool(t.item() > 0)


def broadcast_object(obj, src: int = 0):
    """`obj` of rank `src` on every rank."""
    if not is_multiprocess():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, device=_STATE.device)
    return box[0]


def barrier() -> None:
    """Wait for every rank (an all-reduce on the group's device)."""
    if is_multiprocess():
        dist.all_reduce(torch.zeros(1, device=_STATE.device or "cpu"))
