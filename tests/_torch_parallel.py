"""Runs a function on N ranks of a gloo process group on the CPU, one
spawned process a rank (one torch thread each), and returns each rank's
result. The function must live in a module the ranks can import without
JAX (this one, or another torch-only helper): it is called as
fn(rank, world, *args, **kwargs) after the rank joined the group through
gennerf_tpu_torch.parallel.distributed.init_distributed."""
import os
import socket
import tempfile
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(rank, world, port, fn, args, kwargs, out_dir, join):
    torch.set_num_threads(1)
    from gennerf_tpu_torch.parallel import distributed

    path = os.path.join(out_dir, f"rank{rank}.pt")
    try:
        if join:
            distributed.init_distributed("cpu", coordinator_address=f"localhost:{port}",
                                         num_processes=world, process_id=rank, timeout_s=120)
            result = fn(rank, world, *args, **kwargs)
        else:
            result = fn(rank, world, port, *args, **kwargs)
        torch.save({"ok": result}, path)
    except BaseException:
        torch.save({"error": traceback.format_exc()}, path)
        raise
    finally:
        distributed.shutdown()


def run_ranks(fn, world: int = 2, args=(), kwargs=None, timeout: float = 240.0,
              join: bool = True):
    """[fn's result on rank 0, ..., rank world-1]; a rank's exception is
    raised here with its traceback. `join=False`: the ranks join no group
    here, and fn is called as fn(rank, world, port, *args, **kwargs) with
    a free port for its own."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as out_dir:
        port = free_port()
        procs = [ctx.Process(target=_entry, args=(r, world, port, fn, args, kwargs or {}, out_dir,
                                                     join))
                 for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        results = []
        for r in range(world):
            path = os.path.join(out_dir, f"rank{r}.pt")
            if not os.path.exists(path):
                raise RuntimeError(f"rank {r} wrote no result (exit code {procs[r].exitcode})")
            got = torch.load(path, weights_only=False)
            if "error" in got:
                raise RuntimeError(f"rank {r} failed:\n{got['error']}")
            results.append(got["ok"])
        return results


# -- the step on one process and on each rank ----------------------------------------

def to_numpy_tree(tree):
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in tree.items()}


def run_steps(model_cfg, precision, state, batch, seed=0, steps=1, draws=None,
              world=1, rank=0, evaluate=False):
    """`steps` train steps of the port's model (built from `model_cfg` in
    `precision`, weights `state`) on `batch`: on one process when world
    is 1 and no group is joined, else on this rank's rows of it
    (shard_batch) as a sharded step.
    Returns the metrics of each step, the first step's (reduced)
    gradients, the final state dict and, with `evaluate`, an eval step's
    metrics; all numpy."""
    from gennerf_tpu_torch.parallel.mesh import shard_batch
    from gennerf_tpu_torch.predict import build_model
    from gennerf_tpu_torch.train.state import make_optimizer
    from gennerf_tpu_torch.train.step import StepDraws, batch_to_device, eval_step, train_step

    model = build_model(model_cfg, "cpu", 0, precision)
    if state is not None:
        model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    opt = make_optimizer(model.parameters(), model.cfg.optimizer)
    local, split = shard_batch(batch, world, rank)
    tb = batch_to_device(local, "cpu")
    gen = torch.Generator().manual_seed(seed)
    out = {"metrics": [], "grads": None, "sharded": split}
    for s in range(steps):
        d = StepDraws() if draws is None else StepDraws(*(
            torch.from_numpy(v) if isinstance(v, np.ndarray) else v for v in draws[s]))
        metrics = train_step(model, opt, tb, gen, d, sharded=split)
        out["metrics"].append({k: float(v) for k, v in metrics.items()})
        if s == 0:
            out["grads"] = {n: (None if p.grad is None else p.grad.numpy().copy())
                            for n, p in model.named_parameters()}
    out["state"] = to_numpy_tree(model.state_dict())
    if evaluate:
        metrics = eval_step(model, tb, torch.Generator().manual_seed(seed + 1), sharded=split)
        out["eval"] = {k: float(v) for k, v in metrics.items()}
    return out


def step_rank(rank, world, *args, **kwargs):
    return run_steps(*args, world=world, rank=rank, **kwargs)
