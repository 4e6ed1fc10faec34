"""One bf16-mixed train step with the GenNerf options on, in the port
against the JAX package on the CPU: the loss, every metric and every
gradient against `jax.value_and_grad` of the JAX `gen_nerf_forward_loss`
in bf16, the JAX step's draws injected (`StepDraws`: presample, FPS start
or voxel_hash's scores, pixel scores, ray noise, the render mode's pixel
scores). The options go in four groups, as tests/test_torch_options_steps.py
does in float32: SPADE + LayerNorm + the UNet's 'add', and the grid plane
(UNet3D) + voxel_hash (distillation's steps, with this file's check, are
in tests/test_torch_distill_bf16.py). The learned merger has no step of
its own: a step encodes once and merges nothing (its merge is in
tests/test_torch_options_bf16.py). Sizes and helpers are that file's.

The bf16 reference is JAX's op-by-op bf16: XLA's fusions keep bf16
products in float32 and skip roundings (a compiled step lies up to 5x
the bf16-to-float32 distance from the op-by-op one on the distillation
loss), so the step is compiled with xla_allow_excess_precision off, the
CPU fusion and algebraic-simplifier passes off and backend optimization
level 0: its results equal `jax.disable_jit()`'s bit for bit, at a third
of the time. The float32 reference, which only sets the distance, is
compiled as usual.

Bounds. The distance of a result is JAX's bf16 result against JAX's
float32 result. The loss and every metric: the mean absolute difference
to JAX's bf16 at most half the distance, the largest at most the
largest distance (floor 1e-7 of the largest magnitude: the bounds of
tests/test_torch_gennerf_bf16.py). The gradients: over all parameters
together (each tensor over its float32 largest magnitude) the mean
difference at most half the mean distance; each tensor's mean and
largest difference at most twice its mean and largest distance, or
one bf16 step (2^-7) of its largest magnitude where that is more (a
scalar such as head_geo.fc.bias has one value, whose distance can be
far below a bf16 step: 4.7e-6 against the 3.1e-5 flip of its bf16 sum
under grid + voxel_hash). The forward passes agree bit for
bit (tests/test_torch_options_bf16.py); the backward passes round every
bf16 cotangent in their own summation order, and a bias's gradient, a
sum of many such cotangents, lands as far from JAX's bf16 as JAX's is
from float32: measured up to 1.25 times the mean and 1.72 times the
largest distance (head_geo.fc.bias under surface distillation, the
UNet's upconv bias with the teacher volume), and in some tensors nearer
float32 than JAX's bf16, in others farther (0.25-1.46 of JAX's own
distance).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gennerf_tpu.train.step import gen_nerf_forward_loss as j_forward_loss
from gennerf_tpu_torch.train.step import batch_to_device, gen_nerf_forward_loss
from gennerf_tpu_torch.utils.port_params import gen_nerf_params_from_flax
from test_torch_options import _f32_highest  # noqa: F401
from test_torch_options_bf16 import VD, _near, _np, _port, _step_draws, setup

import _torch_threads  # noqa: F401  (sizes torch's threads per xdist worker)

GROUPS = {
    "spade_layer_norm_add": ("spade", "layer_norm", "add"),
    "grid_voxel_hash": ("grid", "voxel_hash"),
}
# the op-by-op bf16 arithmetic of jax.disable_jit(), compiled
BF16_ULP = 2.0 ** -7  # one bf16 step, relative to the value
STRICT_BF16 = {"xla_allow_excess_precision": False, "xla_backend_optimization_level": 0,
               "xla_disable_hlo_passes": "cpu-instruction-fusion,algsimp"}


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_train_step_bf16(group):
    check_step(*GROUPS[group])


def check_step(*names):
    """One step of the cases `names` together against JAX's (the module
    docstring has the bounds)."""
    cfg, task32, task16, tree, b = setup(*names)
    key = jax.random.PRNGKey(11)
    jbatch = {k: jnp.asarray(v) for k, v in b.items()}

    def value_and_grad(task):
        def f(p):
            loss, metrics, _ = j_forward_loss(task.model, task.cfg, p, {}, jbatch, key, VD, True)
            return loss, metrics

        return jax.value_and_grad(f, has_aux=True)(jax.tree.map(jnp.asarray, tree))

    (_, m32), g32 = jax.jit(lambda: value_and_grad(task32))()
    (_, m16), g16 = jax.jit(lambda: value_and_grad(task16)).lower().compile(
        compiler_options=STRICT_BF16)()
    model = _port(cfg, tree).train()
    distill = task32.cfg.loss.distill
    draws = _step_draws(key, task32.cfg.encoder.pointnet.sparsifier,
                        task32.cfg.loss.use_distill and distill.mode == "render")
    loss, metrics = gen_nerf_forward_loss(model, batch_to_device(b, "cpu"), draws=draws)
    loss.backward()
    assert loss.dtype == torch.float32 and set(metrics) == set(m16)
    assert ("distill" in metrics) == task32.cfg.loss.use_distill
    for k in m16:
        _near(metrics[k], m16[k], m32[k], 0.5, floor=1e-7, name=k)
    g16 = gen_nerf_params_from_flax(jax.tree.map(np.asarray, g16))
    g32 = gen_nerf_params_from_flax(jax.tree.map(np.asarray, g32))
    named = dict(model.named_parameters())
    assert set(named) == set(g16)
    errs, gaps = [], []
    for n, p in named.items():
        assert p.grad.dtype == torch.float32, n
        ours, ref16, ref32 = _np(p.grad), _np(g16[n]), _np(g32[n])
        scale = max(float(np.abs(ref32).max()), 1e-30)
        errs.append(np.abs(ours - ref16).ravel() / scale)
        gaps.append(np.abs(ref16 - ref32).ravel() / scale)
        err, gap = np.abs(ours - ref16), np.abs(ref16 - ref32)
        ulp = BF16_ULP * scale
        assert err.mean() <= max(2 * gap.mean(), ulp), (n, err.mean(), gap.mean())
        assert err.max() <= max(2 * gap.max(), ulp), (n, err.max(), gap.max())
    err, gap = np.concatenate(errs).mean(), np.concatenate(gaps).mean()
    assert err <= 0.5 * gap, (err, gap)
