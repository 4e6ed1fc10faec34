"""The voxel_hash sparsifier, PointNet++ and one GenNerf train step with
the new options on, in the port against the JAX package on the CPU (the
modules and the whole-model encode and decode of each option are in
tests/test_torch_options.py, whose sizes and helpers this file shares).

voxel_hash: its uniform draw injected on both sides, once with a draw made
to tie. PointNet++: the ball query, and the whole forward with the SA
levels' FPS starts injected. The train steps: loss, metrics and every
gradient of one ray-mode step against `jax.value_and_grad` of the JAX
`gen_nerf_forward_loss`, the JAX step's draws injected.

Tolerances, float32: voxel_hash and ball-query indices exactly; the
PointNet++ feature within 1e-5 of its largest magnitude; the train step's
loss within 1e-5 relative and every gradient within 1e-4 of its tensor's
largest magnitude (the tests/test_torch_train.py bounds).
"""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gennerf_tpu.models.pointnetpp import PointNetPlusPlus as JPointNetPlusPlus
from gennerf_tpu.models.pointnetpp import query_ball_point as j_query_ball_point
from gennerf_tpu.ops import sampling as jsamp
from gennerf_tpu.train.step import gen_nerf_forward_loss as j_forward_loss
from gennerf_tpu.train.tasks import GenNerfTask
from gennerf_tpu_torch.models.config import GenNerfConfig, config_from_dict
from gennerf_tpu_torch.models.gen_nerf import GenNerf
from gennerf_tpu_torch.models.pointnetpp import PointNetPlusPlus, query_ball_point
from gennerf_tpu_torch.ops.sampling import voxel_hash_downsample
from gennerf_tpu_torch.train.step import StepDraws, batch_to_device, gen_nerf_forward_loss
from gennerf_tpu_torch.utils.port_params import gen_nerf_params_from_flax
from test_torch_options import (  # noqa: F401
    CFG, H, M_GAUSS, OPTIONS, R, T, VD, W, _close, _encode_draws, _f32_highest, _frames, _merge,
    _randomize, _t,
)


def _jax_voxel_hash(xyz, npoint, rnd):
    """The JAX voxel_hash_downsample with its uniform draw replaced by `rnd`."""
    with mock.patch.object(jsamp.jax.random, "uniform", lambda key, shape: jnp.asarray(rnd)):
        return jsamp.voxel_hash_downsample(jax.random.PRNGKey(0), jnp.asarray(xyz), npoint)


def test_voxel_hash_matches_jax():
    rng = np.random.default_rng(6)
    xyz = rng.uniform(-1, 2, (2, 4096, 3)).astype(np.float32)
    rnd = rng.uniform(0, 1, (2, 4096)).astype(np.float32)
    ref_xyz, ref_idx = _jax_voxel_hash(xyz, 256, rnd)
    ours_xyz, ours_idx = voxel_hash_downsample(_t(xyz), 256, rnd=_t(rnd))
    assert ours_idx.dtype == torch.int32
    np.testing.assert_array_equal(ours_idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(ours_xyz.numpy(), np.asarray(ref_xyz))


def test_voxel_hash_ties():
    """A draw made to tie: 8 distinct values over 16384 points of a
    clustered cloud at npoint 4096 (res 32, ids up to 32767), so that both
    the float32 sort keys ids + rnd/2 and the scores first + rnd*1e-3 hold
    many equal values; the stable sort and the lower-index top-k give the
    JAX indices exactly."""
    rng = np.random.default_rng(7)
    centers = rng.uniform(0, 1, (64, 3))
    xyz = (centers[rng.integers(0, 64, (2, 16384))]
           + 0.01 * rng.standard_normal((2, 16384, 3))).astype(np.float32)
    rnd = (rng.integers(0, 8, (2, 16384)) / 8).astype(np.float32)
    _, ref_idx = _jax_voxel_hash(xyz, 4096, rnd)
    _, ours_idx = voxel_hash_downsample(_t(xyz), 4096, rnd=_t(rnd))
    res = 32
    lo, hi = xyz.min(1, keepdims=True), xyz.max(1, keepdims=True)
    cell = np.clip((xyz - lo) / np.maximum(hi - lo, 1e-6) * res, 0, res - 1).astype(np.int32)
    keys = ((cell[..., 0] * res + cell[..., 1]) * res + cell[..., 2]).astype(np.float32) + rnd * 0.5
    assert len(np.unique(keys[0])) < 0.5 * keys.shape[1]  # the sort keys tie
    np.testing.assert_array_equal(ours_idx.numpy(), np.asarray(ref_idx))


# -- PointNet++ ---------------------------------------------------------------------------

def test_query_ball_point():
    rng = np.random.default_rng(8)
    xyz = rng.uniform(0, 1, (2, 300, 3)).astype(np.float32)
    centroids = xyz[:, :40] + 0.01
    for radius, nsample in ((0.2, 16), (0.05, 8)):
        ref = j_query_ball_point(radius, nsample, jnp.asarray(xyz), jnp.asarray(centroids))
        ours = query_ball_point(radius, nsample, _t(xyz), _t(centroids))
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_pointnetpp():
    """The whole forward with the SA levels' FPS starts injected from the
    JAX key splits (k1, k2) = split(key)."""
    rng = np.random.default_rng(9)
    xyz = rng.uniform(0, 1, (2, 512, 3)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    jm = JPointNetPlusPlus(feature_dim=32)
    params = jax.tree.map(np.asarray, dict(jax.jit(jm.init)(key, jnp.asarray(xyz), key)["params"]))
    ref = jax.jit(jm.apply)({"params": params}, jnp.asarray(xyz), key)
    k1, k2 = jax.random.split(key)
    starts = (_t(jax.random.randint(k1, (2,), 0, 512)), _t(jax.random.randint(k2, (2,), 0, 128)))
    model = PointNetPlusPlus(feature_dim=32)
    state = {}
    for sa, layers in params.items():
        for name, p in layers.items():
            i = int(name.removeprefix("mlp_"))
            state[f"{sa}.mlp.{i}.weight"] = _t(p["kernel"].T)
            state[f"{sa}.mlp.{i}.bias"] = _t(p["bias"])
    model.load_state_dict(state)
    _close(model(_t(xyz), starts=starts), ref)


# -- one train step ---------------------------------------------------------------------

@pytest.mark.parametrize("names", [("spade", "layer_norm", "add"), ("grid", "voxel_hash")],
                         ids=["spade_ln_add", "grid_voxel_hash"])
def test_train_step_with_options(names):
    """Loss, metrics and every gradient of one ray-mode step with the
    options on, the JAX step's draws injected."""
    cfg = CFG
    for name in names:
        cfg = _merge(cfg, OPTIONS[name])
    jtask = GenNerfTask(cfg)
    b = _frames(seed=3)
    batch = {k: jnp.asarray(v) for k, v in b.items()}
    with jax.default_matmul_precision("highest"):
        variables = jax.jit(jtask.model.init, static_argnums=(6,))(
            jax.random.PRNGKey(0), batch["projection"], batch["image"], batch["depth"],
            jnp.zeros((1, 8, 3)), jax.random.PRNGKey(1), VD, jnp.zeros(3))
    tree = _randomize(jax.tree.map(lambda a: np.array(a, np.float32), dict(variables["params"])),
                      np.random.default_rng(11))
    key = jax.random.PRNGKey(12)

    @jax.jit
    def jstep(params):
        def f(p):
            loss, metrics, _ = j_forward_loss(jtask.model, jtask.cfg, p, {}, batch, key, VD, True)
            return loss, metrics
        return jax.value_and_grad(f, has_aux=True)(params)

    (loss_j, metrics_j), grads_j = jstep(jax.tree.map(jnp.asarray, tree))
    model = GenNerf(config_from_dict(GenNerfConfig, cfg))
    model.load_state_dict(gen_nerf_params_from_flax(tree))
    k_enc, k_sample = jax.random.split(key)
    k_pix, k_pts = jax.random.split(k_sample)
    sel, start = _encode_draws(k_enc, model.cfg.encoder.pointnet.sparsifier)
    draws = StepDraws(sel=sel, start=start, scores=_t(jax.random.uniform(k_pix, (T, H * W))),
                      noise=_t(jax.random.normal(k_pts, (T, R, M_GAUSS))))
    loss, metrics = gen_nerf_forward_loss(model, batch_to_device(b, "cpu"), draws=draws)
    loss.backward()
    assert set(metrics) == set(metrics_j)
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5, atol=0)
    ref = gen_nerf_params_from_flax(jax.tree.map(np.asarray, grads_j))
    named = dict(model.named_parameters())
    assert set(named) == set(ref)
    for name, p in named.items():
        r = ref[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), r, rtol=0,
                                   atol=1e-4 * max(np.abs(r).max(), 1e-12), err_msg=name)
