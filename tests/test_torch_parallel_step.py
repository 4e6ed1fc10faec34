"""The port's data-parallel GenNerf step on 2 ranks (gloo, the CPU, one
thread a rank) against its one-process step and against the JAX package's
step, on the same global batch of 4 scenes of 2 frames of 12x16.

The JAX package computes a step as one global program: its masked means
are sums over the whole batch, its draws are the whole batch's. The port's
ranks hold 2 scenes each; each draws the global batch's rows from the
same generator state and keeps its own, and the losses' sums are
all-reduced, so the 2-rank step is the one-process step up to summation
order. The batch's first two scenes (rank 0's) keep 5 valid depth pixels a
frame, fewer than the 16 rays, so the ranks hold different valid counts:
the average of per-rank masked means is off the global mean by far more
than the tolerances.

Tolerances: the 2-rank step against the one-process step: losses and
metrics within 1e-5 relative, every reduced gradient within 1e-5 of its
tensor's largest magnitude, parameters after two steps within 1e-2 * lr
(Adam's first update amplifies float32 noise where a gradient nearly
vanishes; see test_torch_train.py), the two ranks' parameters bit-equal.
Against the JAX step (injected draws, Precision.HIGHEST): loss and
metrics within 1e-5 relative, gradients within 1e-4 of max-abs (the
bounds of test_torch_train's one-step test).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gennerf_tpu.train.step import gen_nerf_forward_loss as j_forward_loss
from gennerf_tpu.train.tasks import GenNerfTask
from gennerf_tpu_torch.data.synthetic import training_batch
from gennerf_tpu_torch.parallel import distributed
from gennerf_tpu_torch.parallel.mesh import shard_batch
from gennerf_tpu_torch.predict import build_model
from gennerf_tpu_torch.train.step import StepDraws, batch_to_device, gen_nerf_forward_loss
from gennerf_tpu_torch.utils.port_params import gen_nerf_params_from_flax

import _torch_threads  # noqa: F401  (sizes torch's threads per xdist worker)
from _torch_parallel import run_ranks, run_steps, step_rank, to_numpy_tree
import _torch_parallel_workers as workers

VOXEL_DIM = (16, 16, 8)
B, T, H, W = 4, 2, 12, 16
R, M_GAUSS = 16, 3
CFG = {
    "type": "GenNerf", "voxel_size": 0.08,
    "voxel_dim_train": [16, 16, 8], "voxel_dim_val": [16, 16, 8], "voxel_dim_test": [16, 16, 8],
    "encoder": {
        "use_spatial": False, "use_pointnet": True,
        "pointnet": {"num_sparse_points": 32, "fps_presample": 64, "normalize_coords": True,
                     "c_dim": 8, "hidden_dim": 8, "plane_resolution": 16, "n_blocks": 2,
                     "unet": True, "unet_kwargs": {"depth": 2, "merge_mode": "concat",
                                                   "start_filts": 8}},
    },
    "mlp": {"d_out_sem": 1, "d_out_geo": 8, "n_blocks": 2, "d_hidden": 32, "alpha": 0.7},
    "code": {"num_freqs": 6, "freq_factor": 0.5, "include_input": True},
    "ray": {"num_rays": R, "N": 5, "M": M_GAUSS},
    "loss": {"use_tsdf": True, "tsdf": {"weight": 1.0, "transform": "smooth_log",
                                        "shift": 15.0, "smoothness": 10.0}},
    "optimizer": {"type": "Adam", "lr": 0.001, "weight_decay": 0.0001},
}
LR = CFG["optimizer"]["lr"]


@pytest.fixture(autouse=True)
def _f32_highest():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture(scope="module")
def batch():
    """4 scenes; scenes 0 and 1 keep 5 valid depth pixels a frame."""
    b = training_batch(B, T, H, W, VOXEL_DIM, 0.08, seed=3)
    keep = np.zeros((H, W), bool)
    keep[4:5, 5:10] = True
    b["depth"][:2] = np.where(keep, b["depth"][:2], 0.0)
    return b


@pytest.fixture(scope="module")
def jax_params(batch):
    """The JAX model's params, every residual block's zero-init fc_1 drawn
    at random so that every gradient is live."""
    task = GenNerfTask(CFG)
    with jax.default_matmul_precision("highest"):
        variables = jax.jit(task.model.init, static_argnums=(6,))(
            jax.random.PRNGKey(0), jnp.asarray(batch["projection"][:1]),
            jnp.asarray(batch["image"][:1]), jnp.asarray(batch["depth"][:1]),
            jnp.zeros((1, 8, 3)), jax.random.PRNGKey(0), VOXEL_DIM, jnp.zeros(3))
    rng = np.random.default_rng(5)
    tree = jax.tree.map(lambda a: np.array(a, np.float32), dict(variables["params"]))

    def randomize(node):
        for k, v in node.items():
            if isinstance(v, dict):
                if k == "Dense_1":
                    v["kernel"] = (0.2 * rng.standard_normal(v["kernel"].shape)).astype(np.float32)
                    v["bias"] = (0.1 * rng.standard_normal(v["bias"].shape)).astype(np.float32)
                else:
                    randomize(v)

    randomize(tree)
    tree["mlp"]["alpha"] = np.asarray(0.7, np.float32)
    return tree


@pytest.fixture(scope="module")
def state(jax_params):
    return to_numpy_tree(gen_nerf_params_from_flax(jax_params))


@pytest.fixture(scope="module")
def runs(state, batch):
    """(one process, [rank 0, rank 1]): two steps from the generator of
    seed 7 and an eval step, each."""
    torch.set_num_threads(1)
    one = run_steps(CFG, "32-true", state, batch, seed=7, steps=2, evaluate=True)
    two = run_ranks(step_rank, 2, args=(CFG, "32-true", state, batch),
                    kwargs=dict(seed=7, steps=2, evaluate=True))
    return one, two


def _close(ours, ref, rel, name=""):
    scale = max(float(np.abs(ref).max()), 1e-12)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=rel * scale, err_msg=name)


def _metrics_close(ours, ref, rel=1e-5):
    assert set(ours) == set(ref)
    for k in ref:
        assert ours[k] == pytest.approx(ref[k], rel=rel, abs=1e-12), k


def test_two_ranks_match_one_process(runs):
    """Loss and metrics of both steps and of the eval step, the first
    step's reduced gradients, the parameters after two steps; both ranks
    end with the same parameters, bit for bit."""
    one, two = runs
    for rank in two:
        for m, ref in zip(rank["metrics"], one["metrics"]):
            _metrics_close(m, ref)
        _metrics_close(rank["eval"], one["eval"])
    assert 0 < one["metrics"][0]["valid_coverage"] < 1
    for name, g in one["grads"].items():
        assert (g is None) == (two[0]["grads"][name] is None), name
        if g is not None:
            _close(two[0]["grads"][name], g, 1e-5, name)
    for k, v in one["state"].items():
        np.testing.assert_array_equal(two[0]["state"][k], two[1]["state"][k], err_msg=k)
        np.testing.assert_allclose(two[0]["state"][k], v, rtol=0, atol=1e-2 * LR, err_msg=k)


def test_one_rank_group_runs_the_machinery(runs, state, batch):
    """A joined group of one rank runs every collective of the sharded
    step (the chip check's NCCL case at world size 1): the one-process
    results within the same bounds."""
    one, two = runs
    assert not one["sharded"] and all(r["sharded"] for r in two)
    (solo,) = run_ranks(step_rank, 1, args=(CFG, "32-true", state, batch),
                        kwargs=dict(seed=7, steps=2, evaluate=True))
    assert solo["sharded"]
    for m, ref in zip(solo["metrics"], one["metrics"]):
        _metrics_close(m, ref)
    _metrics_close(solo["eval"], one["eval"])
    for name, g in one["grads"].items():
        if g is not None:
            _close(solo["grads"][name], g, 1e-5, name)


def test_unequal_valid_counts_take_the_global_mean(state, batch):
    """Each rank's own masked mean (its rows, its rows of the draws)
    differs from the global one; their average is off the 2-rank loss by
    far more than the tolerance, which the 2-rank loss meets."""
    model = build_model(CFG, "cpu", 0, "32-true")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    draws = workers.global_draws(CFG, B * T, H * W, seed=11)
    halves = []
    with torch.no_grad():
        for rank in range(2):
            rows = slice(rank * T * 2, (rank + 1) * T * 2)
            local, _ = shard_batch(batch, 2, rank)
            d = StepDraws(*(None if v is None else torch.from_numpy(v[rows]) for v in draws))
            halves.append(gen_nerf_forward_loss(model, batch_to_device(local, "cpu"),
                                                draws=d)[1])
        whole = gen_nerf_forward_loss(model, batch_to_device(batch, "cpu"), draws=StepDraws(
            *(None if v is None else torch.from_numpy(v) for v in draws)))[1]
    counts = [float(h["valid_coverage"]) for h in halves]
    assert counts[0] < 0.5 < counts[1] == 1.0
    naive = 0.5 * (float(halves[0]["tsdf"]) + float(halves[1]["tsdf"]))
    exact = (counts[0] * float(halves[0]["tsdf"]) + counts[1] * float(halves[1]["tsdf"])) / (
        counts[0] + counts[1])
    assert float(whole["tsdf"]) == pytest.approx(exact, rel=1e-5)
    assert abs(naive - float(whole["tsdf"])) > 1e-2 * float(whole["tsdf"])
    two_rank = run_ranks(workers.forward_rank, 2, args=(CFG, state, batch, draws))
    for rank in two_rank:
        assert rank["tsdf"] == pytest.approx(float(whole["tsdf"]), rel=1e-5)
        assert rank["valid_coverage"] == pytest.approx(float(whole["valid_coverage"]), rel=1e-6)


def _jax_draws(key):
    """The JAX step's draws from `key` (test_torch_train's key splits), numpy."""
    k_enc, k_sample = jax.random.split(key)
    fps_key, k_pre = jax.random.split(k_enc)
    k_pix, k_pts = jax.random.split(k_sample)
    BT = B * T
    return StepDraws(sel=np.asarray(jax.random.randint(k_pre, (BT, 64), 0, H * W)),
                     start=np.asarray(jax.random.randint(fps_key, (BT,), 0, 64)),
                     scores=np.asarray(jax.random.uniform(k_pix, (BT, H * W))),
                     noise=np.asarray(jax.random.normal(k_pts, (BT, R, M_GAUSS))))


def test_two_ranks_match_jax(jax_params, state, batch):
    """The 2-rank step against jax.value_and_grad of the JAX forward loss
    on the whole batch, the JAX draws injected (each rank takes its rows)."""
    task = GenNerfTask(CFG)
    key = jax.random.PRNGKey(11)

    @jax.jit
    def jstep(params, b):
        def f(p):
            loss, metrics, _ = j_forward_loss(task.model, task.cfg, p, {}, b, key, VOXEL_DIM, True)
            return loss, metrics
        return jax.value_and_grad(f, has_aux=True)(params)

    (loss_j, metrics_j), grads_j = jstep(jax.tree.map(jnp.asarray, jax_params),
                                         {k: jnp.asarray(v) for k, v in batch.items()})
    two = run_ranks(step_rank, 2, args=(CFG, "32-true", state, batch),
                    kwargs=dict(draws=[_jax_draws(key)]))
    ref = gen_nerf_params_from_flax(jax.tree.map(np.asarray, grads_j))
    for rank in two:
        m = rank["metrics"][0]
        assert m["combined"] == pytest.approx(float(loss_j), rel=1e-5)
        _metrics_close(m, {k: float(v) for k, v in metrics_j.items()})
        for name, g in rank["grads"].items():
            _close(g, ref[name].numpy(), 1e-4, name)


DISTILL = dict(CFG, mlp=dict(CFG["mlp"], d_out_sem=8),
               teacher={"type": "random_projection", "feature_dim": 8, "seed": 3},
               loss=dict(CFG["loss"], use_feature=True, feature={"weight": 0.01},
                         use_distill=True,
                         distill={"weight": 0.5, "metric": "cosine", "mode": "render",
                                  "render_rays": 8, "gt_warmstart": True}))


def test_loss_feat_and_render_distill_two_ranks(batch):
    """loss_feat (1 / a global mean norm) and render-mode distillation
    (its masked mean, coverage and render_hit_rate) on 2 ranks against one
    process: loss, metrics and reduced gradients."""
    torch.set_num_threads(1)
    one = run_steps(DISTILL, "32-true", None, batch, seed=3)
    two = run_ranks(step_rank, 2, args=(DISTILL, "32-true", None, batch), kwargs=dict(seed=3))
    assert {"feature", "distill", "distill_coverage", "render_hit_rate"} <= set(one["metrics"][0])
    for rank in two:
        _metrics_close(rank["metrics"][0], one["metrics"][0])
        for name, g in one["grads"].items():
            if g is not None:
                _close(rank["grads"][name], g, 1e-5, name)


def test_global_sum_backward_counts_the_loss_once():
    """y = global_sum(2 x) on 2 ranks, then the gradient all-reduce:
    dy/dx = 2 on each rank's x (torch.distributed.nn's all_reduce backward
    would give 4); shared_sum's backward sums the ranks' upstream
    gradients; a parameter without a gradient on every rank keeps None,
    one with a gradient on one rank only gets that rank's."""
    results = run_ranks(workers.reductions_rank, 2)
    for r, got in enumerate(results):
        assert got["global"] == 3.0 and got["x_grad"] == 2.0
        assert got["shared_grad"] == 1.0 + 2.0
        assert got["none_grad"] is None
        assert got["one_rank_grad"] == 5.0


def test_draws_take_the_global_rows():
    """Inside a sharded step a rank's draws (uniform, normal, integer) are
    its rows of the one-process draw of the global batch, and the
    generator ends in the same state; outside one they are the process's
    own draws."""
    results = run_ranks(workers.draws_rank, 2)
    from gennerf_tpu_torch.ops.sampling import _draw, draw_normal, draw_uniform

    g = torch.Generator().manual_seed(5)
    ref = [draw_uniform((6, 3), g, "cpu"), draw_normal((6, 2, 2), g, "cpu"),
           _draw(50, (6,), g, "cpu")]
    after = draw_uniform((2,), g, "cpu")
    for r, got in enumerate(results):
        for a, b in zip(got["draws"], ref):
            np.testing.assert_array_equal(a, b[3 * r:3 * r + 3].numpy())
        np.testing.assert_array_equal(got["after"], after.numpy())
    assert distributed.shard_count() == 1
