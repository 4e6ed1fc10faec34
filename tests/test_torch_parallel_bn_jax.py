"""The port's global BatchNorm on 2 ranks (gloo, the CPU) against the JAX
package's step on the same global batch of 2 scenes.

The JAX step is one jit-global program, so its BatchNorm statistics are
the whole batch's (tests/test_multidevice.py holds its 8-device running
statistics to its 1-device run's). Here each rank holds one scene, the
statistics' sums are all-reduced (parallel.distributed.shared_sum), and
the loss, the reduced gradients and the new running statistics are held
to `jax.value_and_grad` of the JAX loss on both scenes, from the same
flax weights with every BatchNorm scale, bias and running statistic
drawn at random (test_torch_voxelnet.py's and test_torch_spatial.py's
`_randomize`), so every norm does work:

- VoxelNet, norm 'BN', float32 and bf16-mixed (test_torch_voxelnet.py's
  sizes: resnet18 with 2 layers on 2 frames of 32x32, channels [8, 16,
  32], a 16x16x8 volume at 8 cm, heads at 8 and 16 cm; loss_split 'none'
  as in its two-step test, so that no voxel sits on the sparse threshold);
- the spatial-only GenNerf, norm_type 'sync_batch', float32, with
  frame_chunk 1 and remat (the checkpoint's recompute reduces again in
  backward), the JAX step's draws injected (test_torch_spatial.py's
  sizes: resnet18 with 2 layers, 2 frames of 24x32).

Tolerances, float32, those of test_torch_voxelnet.py and
test_torch_spatial.py for one process against JAX: the loss and metrics
within 1e-5 relative, every gradient within 1e-4 of its tensor's largest
magnitude, the running statistics within 1e-5 relative with a floor of
1e-5 of their largest magnitude. One ReLU input of VoxelNet's first up
block (layers_up_res.0.1.bn1) lies on the kink within float32 noise at
this batch: JAX and the port's one-process step put it on one side, the
2 ranks and a float64 step of the port on the other, which moves every
gradient upstream of it by up to 3.0e-2 of max-abs. So a VoxelNet
gradient upstream of the kink that is off JAX's by more than 1e-4 is
refereed by that float64 step: the ranks' gradient must then lie within
1e-4 of the float64 one and nearer to it than JAX's (measured: 72 of 87
tensors, the ranks 2.6e-6 to 2.9e-5 off float64, JAX 2.2e-3 to 3.0e-2;
the port's one-process step is within 9.7e-5 of JAX); the parameters the backward reaches
before the kink (the heads, the last up stage) are held to JAX's directly.
bf16-mixed: the loss at most half its distance from JAX's bf16 loss, the
distance being JAX's bf16 loss against its float32 one (the bound of
test_torch_voxelnet.py's bf16 test); the gradients and running
statistics as near JAX's bf16 step as the port's one-process bf16 step
is, within 5% (the mean difference over all gradients, each tensor over
its float32 largest magnitude, and each statistic's mean difference;
measured 0.999 of it): the port's bf16 VoxelNet backward rounds its bf16
cotangents in its own order, so even its one-process step lies 1.1 to
1.2 times JAX's bf16-to-float32 distance from JAX's bf16 step (eager or
compiled to its op-by-op arithmetic alike), with or without ranks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gennerf_tpu.train.step import gen_nerf_forward_loss as j_forward_loss
from gennerf_tpu.train.tasks import GenNerfTask, VoxelNetTask
from gennerf_tpu_torch.data.synthetic import training_batch
from gennerf_tpu_torch.train.step import StepDraws
from gennerf_tpu_torch.utils.port_params import (
    gen_nerf_params_from_flax, voxel_net_params_from_flax,
)
from test_torch_options_bf16_steps import STRICT_BF16
from test_torch_spatial import SPATIAL_ONLY, _step_draws
from test_torch_spatial import _cfg as spatial_cfg
from test_torch_spatial import _randomize as spatial_randomize
from test_torch_voxelnet import CFG, KEYS, VD, VS, _float64_first_gradients, _port
from test_torch_voxelnet import _randomize as voxel_randomize

import _torch_threads  # noqa: F401  (sizes torch's threads per xdist worker)
from _torch_parallel import run_ranks, run_steps, to_numpy_tree
import _torch_parallel_workers as workers

B, T = 2, 2
VOXELNET = {**CFG, "heads": {"use_tsdf": True, "tsdf": {"multi_scale": True,
                                                        "loss_split": "none"}}}
SPATIAL = spatial_cfg(dict(SPATIAL_ONLY, norm_type="sync_batch"), pointnet=False, remat=True,
                      frame_chunk=1)
# VoxelNet's parameters that the backward reaches before the kink: held
# to JAX's gradients directly
DOWNSTREAM_OF_KINK = ("heads3d.", "backbone3d.layers_up_res.1.", "backbone3d.proj.1.",
                      "backbone3d.layers_up_conv.1.", "backbone3d.layers_up_res.0.1.bn2.",
                      "backbone3d.layers_up_res.0.1.conv2.")
CASES = {"voxelnet-BN-f32": ("voxel", "32-true"), "voxelnet-BN-bf16": ("voxel", "bf16-mixed"),
         "spatial-sync_batch-remat-f32": ("spatial", "32-true")}


@pytest.fixture(autouse=True)
def _f32_highest():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with jax.default_matmul_precision("highest"):
        yield


def _voxel_batch():
    b = training_batch(B, T, 32, 32, VD, VS, seed=3)
    rng = np.random.default_rng(3)
    b["vol_16_tsdf"] = np.clip(rng.uniform(-1.3, 1.3, (B, 1, 8, 8, 4)), -1, 1).astype(np.float32)
    return b


def _init(task, b, voxel: bool):
    args = [jnp.asarray(b[k][:1]) for k in ("projection", "image", "depth")]
    if voxel:
        return task.model.init(jax.random.PRNGKey(0), *args, VD, jnp.zeros(3), None, train=False)
    return jax.jit(task.model.init, static_argnums=(6,))(
        jax.random.PRNGKey(0), *args, jnp.zeros((1, 8, 3)), jax.random.PRNGKey(0), VD,
        jnp.zeros(3))


def _voxel_reference(params, stats, b):
    """{precision: (loss, flax gradients, new batch_stats)} of the JAX
    VoxelNet step on the whole batch."""
    jb = [jnp.asarray(b[k]) for k in ("projection", "image", "depth")]
    targets = {k: jnp.asarray(b[k]) for k in KEYS}
    out = {}
    for precision in ("32-true", "bf16-mixed"):
        model = VoxelNetTask(VOXELNET, precision).model

        def loss_fn(p):
            (_, losses), mutated = model.apply({"params": p, "batch_stats": stats}, *jb, VD,
                                               jnp.zeros(3), targets, train=True,
                                               mutable=["batch_stats"])
            return sum(losses.values()), mutated["batch_stats"]

        fn = jax.jit(lambda p: jax.value_and_grad(loss_fn, has_aux=True)(p))
        if precision == "32-true":
            (loss, new), grads = fn(params)
        else:
            (loss, new), grads = fn.lower(params).compile(compiler_options=STRICT_BF16)(params)
        out[precision] = (float(loss), jax.tree.map(np.asarray, grads),
                          jax.tree.map(np.asarray, new))
    return out


@pytest.fixture(scope="module")
def setup():
    """{case: (the JAX reference, [rank 0, rank 1])}: the 2-rank steps of
    every case on one pair of ranks."""
    torch.set_num_threads(1)
    vb = _voxel_batch()
    vtask = VoxelNetTask(VOXELNET)
    variables = _init(vtask, vb, True)
    vparams, vstats = voxel_randomize(dict(variables["params"]), dict(variables["batch_stats"]), 5)
    vstate = to_numpy_tree(voxel_net_params_from_flax(vparams, vstats))
    vref = _voxel_reference(vparams, vstats, vb)

    sb = training_batch(B, T, 24, 32, VD, VS, seed=4)
    stask = GenNerfTask(SPATIAL)
    variables = _init(stask, sb, False)
    sparams, sstats = spatial_randomize(dict(variables["params"]),
                                        dict(variables["batch_stats"]), 5)
    sstate = to_numpy_tree(gen_nerf_params_from_flax(sparams, sstats))
    key = jax.random.PRNGKey(11)
    jbatch = {k: jnp.asarray(v) for k, v in sb.items()}

    def loss_fn(p):
        loss, metrics, new = j_forward_loss(stask.model, stask.cfg, p, sstats, jbatch, key, VD,
                                            train=True)
        return loss, (metrics, new)

    (sloss, (smetrics, snew)), sgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        sparams)
    draws = [StepDraws(*(None if v is None else v.numpy() for v in _step_draws(key, B * T)))]

    cases = [(name, (VOXELNET, precision, vstate, vb), {}) for name, (kind, precision)
             in CASES.items() if kind == "voxel"]
    cases.append(("spatial-sync_batch-remat-f32", (SPATIAL, "32-true", sstate, sb),
                  {"draws": draws}))
    two = run_ranks(workers.cases_rank, 2, args=(cases,), timeout=600)
    g64 = _float64_first_gradients(_port(vparams, vstats, VOXELNET), vb)
    extra = {"voxelnet-BN-f32": {n: g.numpy() for n, g in g64.items()},
             "voxelnet-BN-bf16": run_steps(VOXELNET, "bf16-mixed", vstate, vb),
             "spatial-sync_batch-remat-f32": {k: float(v) for k, v in smetrics.items()}}
    refs = {"voxelnet-BN-f32": (vref["32-true"], vparams),
            "voxelnet-BN-bf16": (vref["bf16-mixed"], vparams, vref["32-true"]),
            "spatial-sync_batch-remat-f32": ((float(sloss), jax.tree.map(np.asarray, sgrads),
                                              jax.tree.map(np.asarray, snew)), sparams)}
    return {name: (refs[name], [r[name] for r in two], extra[name]) for name in CASES}


def _port_tree(case, params, grads_or_stats, stats: bool):
    convert = voxel_net_params_from_flax if case.startswith("voxel") else gen_nerf_params_from_flax
    if stats:
        return {k: v.numpy() for k, v in convert(params, grads_or_stats).items()
                if "running_" in k}
    return {k: v.numpy() for k, v in convert(grads_or_stats).items()}


def _rel(a, b) -> float:
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)


@pytest.mark.parametrize("case", [c for c in CASES if CASES[c][1] == "32-true"])
def test_batchnorm_two_ranks_match_jax_f32(setup, case):
    """float32: the 2-rank loss, metrics, reduced gradients and running
    statistics against the JAX step on the whole batch (module docstring;
    VoxelNet's gradients across the ReLU kink refereed by float64)."""
    ((loss, grads, new), params), ranks, extra = setup[case]
    voxel = case.startswith("voxel")
    ref_grads = _port_tree(case, params, grads, False)
    ref_stats = _port_tree(case, params, new, True)
    assert len(ref_stats) >= 10
    for rank in ranks:
        m = rank["metrics"][0]
        assert m["tsdf_loss" if voxel else "combined"] == pytest.approx(loss, rel=1e-5)
        if not voxel:
            for k, v in extra.items():
                np.testing.assert_allclose(m[k], v, rtol=1e-5, atol=1e-7, err_msg=k)
        assert set(rank["grads"]) <= set(ref_grads)
        for n, g in rank["grads"].items():
            if _rel(g, ref_grads[n]) <= 1e-4:
                continue
            assert voxel and not n.startswith(DOWNSTREAM_OF_KINK), n
            g64 = extra[n]
            assert _rel(g, g64) <= 1e-4 and _rel(g, g64) < _rel(ref_grads[n], g64), n
        for k, ref in ref_stats.items():
            np.testing.assert_allclose(rank["state"][k], ref, rtol=1e-5,
                                       atol=1e-5 * float(np.abs(ref).max()), err_msg=k)


def test_batchnorm_two_ranks_match_jax_bf16(setup):
    """bf16-mixed VoxelNet: the 2-rank loss against JAX's bf16 step, and
    the 2-rank gradients and running statistics as near it as the port's
    one-process bf16 step (module docstring)."""
    ((loss16, g16, new16), params, (loss32, g32, new32)), ranks, one = setup["voxelnet-BN-bf16"]
    case = "voxelnet-BN-bf16"
    g16, g32 = _port_tree(case, params, g16, False), _port_tree(case, params, g32, False)
    s16 = _port_tree(case, params, new16, True)

    def grad_distance(grads):
        return float(np.concatenate([np.abs(g - g16[n]).ravel() / np.abs(g32[n]).max()
                                     for n, g in grads.items()]).mean())

    own = grad_distance(one["grads"])
    for rank in ranks:
        m = rank["metrics"][0]["tsdf_loss"]
        assert abs(m - loss16) <= 0.5 * abs(loss16 - loss32) + 1e-6
        assert set(rank["grads"]) == set(one["grads"])
        assert grad_distance(rank["grads"]) <= 1.05 * own
        for k, ref in s16.items():
            err = np.abs(rank["state"][k] - ref).mean()
            assert err <= 1.05 * np.abs(one["state"][k] - ref).mean() + 1e-7 * np.abs(ref).max(), k
