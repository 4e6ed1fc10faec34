"""Render-mode distillation of the port on the CPU against the JAX package,
in float32: the march through the current field (the rays of the render
pixels, the hit mask, the depths and the supervised points), and the
forward loss and one train step's gradients with gt_warmstart on and off,
`render_hit_rate` included (over all rays, not scaled by T), and a
render-mode eval step.

Sizes as test_torch_distill.py (2 frames of 30x41, both with enough valid
depth pixels for every ray, so no ray is backfilled; 12 render rays a
frame, a 10 + 4 + 3 march). The head's bias is shifted so that the
decoded field's median over the volume is 0: a random field need not
cross zero, and the march would then find nothing.

The first crossing is a sign test, so a float32 difference between XLA
and torch could flip a ray's hit: the hit masks are compared first (on
this input they agree on every ray), depths and decoded features only
where both hit. Tolerances: depths within 1e-4 m, points and the teacher
targets within 1e-5 of their largest magnitude; losses and metrics within
1e-5 relative; every parameter gradient within 1e-4 of its tensor's
largest magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gennerf_tpu import ops as jops
from gennerf_tpu.models import renderer as jrenderer
from gennerf_tpu.models.gen_nerf import GenNerf as JGenNerf
from gennerf_tpu_torch.train.step import (
    batch_to_device, eval_step, gen_nerf_forward_loss, render_distill_points,
)
from test_torch_distill import (  # noqa: F401
    H, T, VOXEL_DIM, VS, W, _close, _f32_highest, cfg_dict, check_step, full_batch,
    jax_loss_and_grads, jax_params, port_model, step_draws,
)

import _torch_threads  # noqa: F401  (sizes torch's threads per xdist worker)

RR = 12
MARCH = {"render_rays": RR, "render_steps": 10, "render_fine": 4, "render_secant": 3,
         "render_near": 0.05, "render_far": 4.0}


def centred(task, params, batch):
    """params with the head's bias moved so that the median pre-tanh head
    over the volume's grid (of the scene's JAX encode) is 0."""
    key = jax.random.PRNGKey(0)
    repr_j = task.model.apply({"params": params},
                              *(jnp.asarray(batch[k]) for k in ("projection", "image", "depth")),
                              key, VOXEL_DIM, jnp.zeros(3), method=JGenNerf.encode)
    grid = np.stack(np.meshgrid(*(np.arange(n) * VS for n in VOXEL_DIM), indexing="ij"), -1)
    out = task.model.apply({"params": params}, repr_j, jnp.asarray(grid.reshape(1, -1, 3)),
                           jnp.zeros(3), method=JGenNerf.decode)
    dense = params["head_geo"]["Dense_0"]
    pre = np.asarray(out["feat_geo"][0]) @ dense["kernel"][:, 0] + dense["bias"][0]
    params = jax.tree.map(np.copy, params)
    params["head_geo"]["Dense_0"]["bias"] = dense["bias"] - np.float32(np.median(pre))
    return params


def jax_render_branch(task, params, batch, key):
    """The JAX step's march, replayed from its code
    (gennerf_tpu/train/step.py render branch): hits (BT, RR), depths and
    the supervised points (B, T*RR, 3)."""
    cfg, dcfg = task.cfg, task.cfg.loss.distill
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    k_enc, k_sample = jax.random.split(key)
    variables = {"params": params}
    repr_ = task.model.apply(variables, b["projection"], b["image"], b["depth"], k_enc,
                             VOXEL_DIM, jnp.zeros(3), method=JGenNerf.encode)
    BT = T
    _, h, w, ok = jops.sample_valid_depth_pixels(jax.random.fold_in(k_sample, 7),
                                                 b["depth"].reshape(BT, H, W), RR)
    origins, dirs = jrenderer.pixels_to_rays(h.astype(jnp.float32), w.astype(jnp.float32),
                                             b["intrinsics"].reshape(BT, 3, 3),
                                             b["pose"].reshape(BT, 4, 4))
    origins, dirs = origins.reshape(1, T * RR, 3), dirs.reshape(1, T * RR, 3)
    depth, hit = jrenderer.ray_march_tsdf(
        lambda p: task.model.apply(variables, repr_, p, jnp.zeros(3),
                                   method=JGenNerf.decode)["tsdf"][..., 0],
        origins, dirs, near=dcfg.render_near, far=dcfg.render_far, n_steps=dcfg.render_steps,
        n_secant_steps=dcfg.render_secant, n_fine_steps=dcfg.render_fine, convention="fusion",
        aabb=(jnp.zeros(3), jnp.asarray(VOXEL_DIM, jnp.float32) * cfg.voxel_size))
    return hit.reshape(BT, RR), depth, origins + dirs * depth[..., None], ok, h, w


@pytest.mark.parametrize("warmstart", [True, False], ids=["gt_warmstart", "no_warmstart"])
def test_render_step_matches_jax(full_batch, warmstart):
    """The march (hit masks equal, depths where both hit), then the loss,
    metrics and every parameter's gradient of a render-mode train step;
    render_hit_rate is the share of all rays that hit, unscaled by T."""
    batch = full_batch
    cfg = cfg_dict("render", warmstart=warmstart, **MARCH)
    task, params, _ = jax_params(cfg, batch)
    params = centred(task, params, batch)
    key = jax.random.PRNGKey(21)
    draws = step_draws(key, cfg)
    hit_j, depth_j, pts_j, ok_j, h_j, w_j = jax.jit(
        lambda p: jax_render_branch(task, p, batch, key))(params)
    hit_j, depth_j = np.asarray(hit_j), np.asarray(depth_j).reshape(T, RR)
    assert np.asarray(ok_j).all() and 0.1 < hit_j.mean() < 0.9

    model = port_model(cfg, params)
    tb = batch_to_device(batch, "cpu")
    with torch.no_grad():
        repr_ = model.encode(tb["projection"], tb["image"], tb["depth"], sel=draws.sel,
                             start=draws.start, voxel_dim=VOXEL_DIM)
    points, h, w, mask, hit = render_distill_points(model, tb, repr_, torch.zeros(3),
                                                    VOXEL_DIM, scores=draws.render_scores)
    np.testing.assert_array_equal(h.numpy(), np.asarray(h_j))
    np.testing.assert_array_equal(w.numpy(), np.asarray(w_j))
    agree = float((hit.numpy() == hit_j).mean())
    assert agree == 1.0, f"hit masks agree on {agree:.4f} of the rays"
    both = hit.numpy()
    _close(points[0].reshape(T, RR, 3)[torch.from_numpy(both)],
           np.asarray(pts_j)[0].reshape(T, RR, 3)[both], name="points")
    cameras = tb["pose"][0, :, None, :3, 3]  # the rays' origins, (T, 1, 3)
    dist = (points[0].reshape(T, RR, 3) - cameras).norm(dim=-1)
    np.testing.assert_allclose(dist.numpy()[both], depth_j[both], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(mask.numpy(), np.ones_like(both) if warmstart else both)

    metrics_j, grads_j = jax_loss_and_grads(task, params, {}, batch, key)
    assert metrics_j["render_hit_rate"] == float(hit_j.mean(dtype=np.float32))
    loss, metrics = gen_nerf_forward_loss(model, tb, draws=draws)
    loss.backward()
    check_step(model, metrics, metrics_j, grads_j)
    assert float(metrics["render_hit_rate"]) == float(hit.to(torch.float32).mean())
    assert float(metrics["distill_coverage"]) == (
        1.0 if warmstart else float(both.mean(dtype=np.float32)))


def test_render_eval_step_matches_jax(full_batch):
    """A render-mode eval step (no_grad; l2) distills at the march's points too."""
    cfg = cfg_dict("render", metric="l2", **MARCH)
    task, params, _ = jax_params(cfg, full_batch)
    params = centred(task, params, full_batch)
    key = jax.random.PRNGKey(22)
    metrics_j, _ = jax_loss_and_grads(task, params, {}, full_batch, key, train=False)
    metrics = eval_step(port_model(cfg, params), batch_to_device(full_batch, "cpu"),
                        draws=step_draws(key, cfg))
    assert 0 < metrics_j["render_hit_rate"] < 1
    check_step(None, metrics, metrics_j)
