"""Functions the parallel tests run on each rank (torch only: the ranks
import no JAX)."""
import numpy as np
import torch

from gennerf_tpu_torch.parallel import distributed
from gennerf_tpu_torch.train.step import StepDraws


def global_draws(cfg, BT, npix, seed):
    """A ray-mode step's draws for BT frames from a numpy seed."""
    rng = np.random.default_rng(seed)
    presample = cfg["encoder"]["pointnet"]["fps_presample"]
    ray = cfg["ray"]
    return StepDraws(sel=rng.integers(0, npix, (BT, presample)),
                     start=rng.integers(0, presample, (BT,)),
                     scores=rng.random((BT, npix), dtype=np.float32),
                     noise=rng.standard_normal((BT, ray["num_rays"], ray["M"]), np.float32))


def forward_rank(rank, world, cfg, state, batch, draws):
    """The forward loss's metrics of this rank's rows in a sharded step."""
    from gennerf_tpu_torch.parallel.mesh import shard_batch
    from gennerf_tpu_torch.predict import build_model
    from gennerf_tpu_torch.train.step import batch_to_device, gen_nerf_forward_loss, rank_draws

    model = build_model(cfg, "cpu", 0, "32-true")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    local, split = shard_batch(batch, world, rank)
    d = StepDraws(*(None if v is None else torch.from_numpy(v) for v in draws))
    with distributed.sharded(split), torch.no_grad():
        _, metrics = gen_nerf_forward_loss(model, batch_to_device(local, "cpu"),
                                           draws=rank_draws(d))
    return {k: float(v) for k, v in metrics.items()}


def reductions_rank(rank, world):
    """global_sum / shared_sum backward and all_reduce_gradients' None rule."""
    out = {}
    with distributed.sharded():
        x = torch.tensor(float(rank) + 1.0, requires_grad=True)  # 1, 2
        y = distributed.global_sum(x * 1.0)
        out["global"] = float(y)
        x2 = torch.tensor(1.0, requires_grad=True)
        (distributed.global_sum(2.0 * x2)).backward()
        out["x_grad"] = float(x2.grad)
        s = torch.tensor(1.0, requires_grad=True)
        (distributed.shared_sum(s * 1.0) * (rank + 1.0)).backward()
        out["shared_grad"] = float(s.grad)
        none, one = torch.nn.Parameter(torch.zeros(1)), torch.nn.Parameter(torch.zeros(1))
        if rank == 1:
            one.grad = torch.full((1,), 5.0)
        distributed.all_reduce_gradients([none, one])
        out["none_grad"] = None if none.grad is None else float(none.grad)
        out["one_rank_grad"] = float(one.grad)
    return out


def draws_rank(rank, world):
    """The sampling helpers' draws inside a sharded step, and the
    generator's next draw after them."""
    from gennerf_tpu_torch.ops.sampling import _draw, draw_normal, draw_uniform

    g = torch.Generator().manual_seed(5)
    with distributed.sharded():
        draws = [draw_uniform((3, 3), g, "cpu"), draw_normal((3, 2, 2), g, "cpu"),
                 _draw(50, (3,), g, "cpu")]
    after = draw_uniform((2,), g, "cpu")
    return {"draws": [d.numpy() for d in draws], "after": after.numpy()}


def cases_rank(rank, world, cases):
    """run_steps of each (name, args, kwargs) case on this rank."""
    from _torch_parallel import run_steps

    return {name: run_steps(*args, world=world, rank=rank, **kwargs)
            for name, args, kwargs in cases}


def initial_state(case):
    """The state dict (numpy) of a case's model before any step."""
    from gennerf_tpu_torch.predict import build_model

    cfg, precision = case[0], case[1]
    return {k: v.numpy() for k, v in build_model(cfg, "cpu", 0, precision).state_dict().items()}


def decode_rank(rank, world, cfg, state, planes, voxel_dim, origin, bf16_feeds=False):
    """decode_grid_sharded of the model and planes on this rank (the
    plain decode per slab, its bf16-feed version when asked)."""
    from gennerf_tpu_torch.models.gen_nerf import SceneRepr
    from gennerf_tpu_torch.ops.grid_decode import separable_grid_decode_plain
    from gennerf_tpu_torch.predict import build_model
    from gennerf_tpu_torch.train import predict

    model = build_model(cfg, "cpu", 0, "32-true")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    repr_ = SceneRepr({k: torch.from_numpy(v) for k, v in planes.items()})
    if bf16_feeds:
        predict.grid_decode = lambda t, w: separable_grid_decode_plain(t, w, bf16_feeds=True)
    try:
        vol = predict.predict_tsdf_volume(model, repr_, voxel_dim, 0.08, torch.from_numpy(origin),
                                          sharded=True)
        return vol.numpy()
    except NotImplementedError as e:
        return str(e)


def platform_rank(rank, world, cases):
    """select_platform of each trainer config inside the joined group:
    the device's type, or the error's type and message."""
    from gennerf_tpu_torch.parallel.platform import select_platform

    out = []
    for cfg in cases:
        try:
            out.append(select_platform(cfg, "cpu").type)
        except (ValueError, RuntimeError) as e:
            out.append((type(e).__name__, str(e)))
    return out


def node_rank_rank(rank, world, port, named, per_node=2):
    """select_platform of one rank of a run on world / per_node nodes, the
    environment as a multi-node launcher sets it (LOCAL_RANK,
    LOCAL_WORLD_SIZE, WORLD_SIZE, MASTER_*; RANK too when `named`), the
    node's index in trainer.node_rank; returns the group's view of it."""
    import os

    import torch.distributed as dist

    from gennerf_tpu_torch.parallel.platform import select_platform

    os.environ.update(WORLD_SIZE=str(world), LOCAL_RANK=str(rank % per_node),
                      LOCAL_WORLD_SIZE=str(per_node), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    if named:
        os.environ["RANK"] = str(rank)
    cfg = {"accelerator": "cpu", "devices": per_node, "num_nodes": world // per_node,
           "node_rank": rank // per_node}
    try:
        device = select_platform(cfg, "cpu")
        total = torch.tensor([float(rank)])
        dist.all_reduce(total)
        return {"rank": dist.get_rank(), "world": dist.get_world_size(), "device": device.type,
                "sum": float(total)}
    finally:
        distributed.shutdown()
