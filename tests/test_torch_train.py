"""The port's training slice on the CPU against the JAX package: the value
transforms and loss terms, the supervision samplers, the trilinear target
lookup and TSDF fusion, one train step's loss, metrics and gradients
against `jax.value_and_grad` of `gen_nerf_forward_loss`, three optimizer
steps against `make_gen_nerf_train_step`, the params round trip, resume
identity and the train CLI.

Sizes are small (2 frames of 12x16, c_dim 8, H 32, 2 blocks, a 16x16x8
grid, 16 rays of 1 + 5 + 3 samples). The JAX step's draws are injected
into the port from the same key splits: (k_enc, k_sample) = split(key),
(fps_key, k_pre) = split(k_enc), (k_pix, k_pts) = split(k_sample); the
presample from k_pre, the FPS start from fps_key, the pixel scores
uniform(k_pix, (BT, H*W)) and the ray noise normal(k_pts, (BT, R, M)).

Tolerances: one step's loss within 1e-5 relative and every gradient
within 1e-4 of its tensor's largest magnitude (float32 through encode,
decode and the loss in another summation order). Three steps: losses
within 1e-4 relative; parameters within 1e-2 * lr absolute for all but
0.1% of the elements and within 1e-1 * lr for every one. The wider bound
is for elements where the gradient and the coupled L2 term nearly cancel:
in this case a UNet weight's first gradient is 1.04e-6 against
wd * p = -1.00e-6, leaving 3.5e-8, so the frameworks' float32 difference
of 2e-9 (1e-6 of its tensor's largest gradient) is 5% of the sum, and
Adam's first update, lr * g / (|g| + 1e-8), carries it as 5% of lr.
"""
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gennerf_tpu.data.synthetic import random_primitives as j_random_primitives
from gennerf_tpu.models import losses as jl
from gennerf_tpu.models.config import LossConfig as JLossConfig
from gennerf_tpu.models.config import config_from_dict as j_config_from_dict
from gennerf_tpu.ops import interpolation as jinterp
from gennerf_tpu.ops import sampling as jsamp
from gennerf_tpu.ops import value_transforms as jvt
from gennerf_tpu.train.state import create_train_state
from gennerf_tpu.train.state import lr_for_epoch as j_lr_for_epoch
from gennerf_tpu.train.state import set_learning_rate as j_set_learning_rate
from gennerf_tpu.train.step import gen_nerf_forward_loss as j_forward_loss
from gennerf_tpu.train.tasks import GenNerfTask
from gennerf_tpu.tsdf.fusion import fuse_frames as j_fuse_frames
from gennerf_tpu_torch.data.synthetic import random_primitives, training_batch
from gennerf_tpu_torch.models import losses as tl
from gennerf_tpu_torch.models.config import GenNerfConfig, LossConfig, config_from_dict
from gennerf_tpu_torch.models.gen_nerf import GenNerf
from gennerf_tpu_torch.ops import interpolation as tinterp
from gennerf_tpu_torch.ops import sampling as tsamp
from gennerf_tpu_torch.ops import value_transforms as tvt
from gennerf_tpu_torch.ops.coords import coordinate2index, normalize_coordinate
from gennerf_tpu_torch.ops.scatter import pool_and_gather
from gennerf_tpu_torch.predict import main as predict_main
from gennerf_tpu_torch.predict import reconstruct
from gennerf_tpu_torch.train.__main__ import main as train_main
from gennerf_tpu_torch.train.checkpoints import load_checkpoint
from gennerf_tpu_torch.train.loop import Trainer
from gennerf_tpu_torch.train.state import lr_for_epoch, make_optimizer, set_learning_rate
from gennerf_tpu_torch.train.step import (
    StepDraws, batch_to_device, eval_step, gen_nerf_forward_loss, train_step,
)
from gennerf_tpu_torch.tsdf.fusion import fuse_frames
from gennerf_tpu_torch.utils.port_params import (
    flax_params_from_gen_nerf, gen_nerf_params_from_flax, load_params_npz,
)

import _torch_threads  # noqa: F401  (sizes torch's threads per xdist worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOXEL_DIM = (16, 16, 8)
T, H, W = 2, 12, 16
R, N_STRAT, M_GAUSS = 16, 5, 3
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
    "ray": {"num_rays": R, "N": N_STRAT, "M": M_GAUSS},
    "loss": {"use_tsdf": True, "tsdf": {"weight": 1.0, "transform": "smooth_log",
                                        "shift": 15.0, "smoothness": 10.0}},
    "optimizer": {"type": "Adam", "lr": 0.001, "weight_decay": 0.0001},
    "scheduler": {"type": "StepLR", "step_size": 1, "gamma": 0.5},
}
TINY_EXPERIMENT = (
    "defaults:\n  - overfit_synthetic\n"
    "model:\n  encoder:\n    pointnet:\n      num_sparse_points: 32\n      fps_presample: 64\n"
    "      c_dim: 8\n      hidden_dim: 8\n      plane_resolution: 16\n      n_blocks: 2\n"
    "      unet_kwargs: {depth: 2, merge_mode: concat, start_filts: 8}\n"
    "  mlp: {d_out_geo: 8, d_out_sem: 1, n_blocks: 2, d_hidden: 32}\n"
    "  ray: {num_rays: 8, N: 4, M: 2}\n"
    "trainer: {log_every_n_steps: 1, check_val_every_n_epoch: 1}\n"
    "data:\n  voxel_size: 0.08\n  voxel_dim_train: [16, 16, 8]\n  voxel_dim_test: [16, 16, 8]\n"
    "  num_frames_train: 2\n  num_frames_val: 2\n")


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(autouse=True)
def _f32_highest():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture(scope="module")
def batch():
    """One scene of 2 frames; the second frame keeps only 5 valid depth
    pixels, fewer than the 16 rays, so some rays are backfilled."""
    b = training_batch(1, T, H, W, VOXEL_DIM, 0.08, seed=3)
    keep = np.zeros((H, W), bool)
    keep[4:5, 5:10] = True
    b["depth"][0, 1] = np.where(keep, b["depth"][0, 1], 0.0)
    return b


@pytest.fixture(scope="module")
def jax_params(batch):
    """The JAX model's params with every residual block's zero-init fc_1
    randomized, and pointnet block 0's output channel 0 made a ReLU output
    (shortcut column 0 and fc_1 column 0 select hidden unit 0, whose bias
    is lowered): its zeros tie in the scatter-max pooling of block 1."""
    task = GenNerfTask(CFG)
    with jax.default_matmul_precision("highest"):
        variables = jax.jit(task.model.init, static_argnums=(6,))(
            jax.random.PRNGKey(0), jnp.asarray(batch["projection"]), jnp.asarray(batch["image"]),
            jnp.asarray(batch["depth"]), jnp.zeros((1, 8, 3)), jax.random.PRNGKey(0),
            VOXEL_DIM, jnp.zeros(3))
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
    blk = tree["pointnet"]["block_0"]
    blk["Dense_2"]["kernel"][:, 0] = 0.0
    blk["Dense_1"]["kernel"][:, 0] = 0.0
    blk["Dense_1"]["kernel"][0, 0] = 1.0
    blk["Dense_1"]["bias"][0] = 0.0
    blk["Dense_0"]["bias"][0] -= 0.3
    tree["mlp"]["alpha"] = np.asarray(0.7, np.float32)
    return tree


def _model(tree, cfg=CFG):
    model = GenNerf(config_from_dict(GenNerfConfig, cfg))
    model.load_state_dict(gen_nerf_params_from_flax(tree))
    return model


def _draws(key, presample=64, npix=H * W, BT=T):
    """The JAX step's draws from `key`, as the port's StepDraws."""
    k_enc, k_sample = jax.random.split(key)
    fps_key, k_pre = jax.random.split(k_enc)
    k_pix, k_pts = jax.random.split(k_sample)
    return StepDraws(
        sel=_t(jax.random.randint(k_pre, (BT, presample), 0, npix)),
        start=_t(jax.random.randint(fps_key, (BT,), 0, presample)),
        scores=_t(jax.random.uniform(k_pix, (BT, npix))),
        noise=_t(jax.random.normal(k_pts, (BT, R, M_GAUSS))))


def _grad_state(tree_grads):
    return gen_nerf_params_from_flax(jax.tree.map(np.asarray, tree_grads))


# -- value transforms and loss terms -------------------------------------------

def test_value_transforms(rng):
    """Including |x| past softplus's linear threshold (beta*|x|/shift > 20)."""
    x = np.concatenate([rng.uniform(-1.2, 1.2, 200), rng.uniform(-80, 80, 50)]).astype(np.float32)
    for shift, beta in ((15.0, 10.0), (20.0, 8.0), (1.0, 1.0)):
        ref = jvt.smooth_log_transform(jnp.asarray(x), shift, beta)
        np.testing.assert_allclose(tvt.smooth_log_transform(_t(x), shift, beta).numpy(),
                                   np.asarray(ref), rtol=1e-6, atol=1e-7)
        g_ref = jax.grad(lambda v: jvt.smooth_log_transform(v, shift, beta).sum())(jnp.asarray(x))
        xt = _t(x).requires_grad_()
        tvt.smooth_log_transform(xt, shift, beta).sum().backward()
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_ref), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tvt.log_transform(_t(x), 2.0).numpy(),
                               np.asarray(jvt.log_transform(jnp.asarray(x), 2.0)), rtol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("terms", [
    {"use_tsdf": True, "tsdf": {"transform": "smooth_log", "shift": 15.0, "smoothness": 10.0}},
    {"use_tsdf": True, "tsdf": {"transform": "log", "shift": 2.0}},
    {"use_tsdf": True, "tsdf": {"transform": "none", "weight": 0.5}},
    {"use_tsdf": False, "use_isdf": True, "isdf": {"weight": 0.7}},
    {"use_tsdf": True, "use_isdf": True, "use_feature": True, "feature": {"weight": 0.2}},
])
def test_loss_terms(rng, terms, masked):
    outputs = {"tsdf": rng.uniform(-1.1, 1.1, (3, 20, 1)).astype(np.float32),
               "feat": rng.standard_normal((3, 20, 4)).astype(np.float32)}
    outputs["feat"][0, :3] = 0.0  # zero vectors: the safe norm's gradient
    targets = {"tsdf": rng.uniform(-1, 1, (3, 20, 1)).astype(np.float32)}
    if masked:
        targets["valid"] = (rng.uniform(size=(3, 20, 1)) > 0.3).astype(np.float32)
    jcfg, tcfg = j_config_from_dict(JLossConfig, terms), config_from_dict(LossConfig, terms)

    def jloss(out):
        return jl.calculate_loss(jcfg, out, {k: jnp.asarray(v) for k, v in targets.items()})

    (ref, ref_terms), ref_grads = jax.value_and_grad(jloss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in outputs.items()})
    out_t = {k: _t(v).requires_grad_() for k, v in outputs.items()}
    ours, our_terms = tl.calculate_loss(tcfg, out_t, {k: _t(v) for k, v in targets.items()})
    ours.backward()
    assert set(our_terms) == set(ref_terms)
    for k in ref_terms:
        np.testing.assert_allclose(float(our_terms[k].detach()), float(ref_terms[k]), rtol=1e-6,
                                   atol=1e-7)
    for k in outputs:
        ref_g = np.asarray(ref_grads[k])
        got = out_t[k].grad.numpy() if out_t[k].grad is not None else np.zeros_like(ref_g)
        np.testing.assert_allclose(got, ref_g, rtol=1e-5, atol=1e-7)


def test_unported_loss_terms_raise():
    """Every loss term is ported (the eikonal and gradient terms are held
    against JAX in test_torch_grad_losses.py, the distillation term in
    test_torch_distill.py); a distillation metric other than cosine or l2
    raises, as the reference's loss_distill does."""
    for flag in ("use_distill",):
        cfg = config_from_dict(LossConfig, {flag: True, "distill": {"metric": "l1"}})
        with pytest.raises(NotImplementedError):
            tl.calculate_loss(cfg, {"tsdf": torch.zeros(1, 2, 1),
                                    "feat_sem_surface": torch.zeros(1, 2, 4)},
                              {"tsdf": torch.zeros(1, 2, 1), "teacher_feat": torch.ones(1, 2, 4)})


def test_segment_max_ties_split_as_jax(rng):
    """Scatter-max pooling's gradient with ReLU zeros and exact ties: each
    of n tied values gets 1/n, as the reference's."""
    from gennerf_tpu.ops.scatter import pool_and_gather as j_pool

    v = np.maximum(rng.standard_normal((2, 40, 3)), 0).astype(np.float32)
    v[0, 3] = v[0, 5]
    idx = rng.integers(0, 9, (2, 40))
    w = rng.standard_normal((2, 40, 3)).astype(np.float32)
    ref = jax.grad(lambda a: (j_pool(a, jnp.asarray(idx), 12, "max") * w).sum())(jnp.asarray(v))
    vt = _t(v).requires_grad_()
    (pool_and_gather(vt, _t(idx), 12, "max") * _t(w)).sum().backward()
    np.testing.assert_array_equal(vt.grad.numpy(), np.asarray(ref))


# -- samplers, target lookup, fusion, synthetic scenes -------------------------

def test_pixel_sampler_with_too_few_valid_pixels(batch):
    depth = batch["depth"].reshape(T, H, W)
    key = jax.random.PRNGKey(7)
    scores = jax.random.uniform(key, (T, H * W))
    _, h_j, w_j, ok_j = jsamp.sample_valid_depth_pixels(key, jnp.asarray(depth), R)
    _, h_t, w_t, ok_t = tsamp.sample_valid_depth_pixels(_t(depth), R, scores=_t(scores))
    ok_j = np.asarray(ok_j)
    np.testing.assert_array_equal(ok_t.numpy(), ok_j)
    assert ok_j[0].all() and ok_j[1].sum() == 5  # frame 1: 5 valid pixels for 16 rays
    # the valid picks come first, in score order; backfilled ties may differ
    np.testing.assert_array_equal(h_t.numpy()[ok_j], np.asarray(h_j)[ok_j])
    np.testing.assert_array_equal(w_t.numpy()[ok_j], np.asarray(w_j)[ok_j])


def test_ray_sampler(batch, rng):
    depth = batch["depth"].reshape(T, H, W)
    K, pose = batch["intrinsics"].reshape(T, 3, 3), batch["pose"].reshape(T, 4, 4)
    h = rng.integers(0, H, (T, R))
    w = rng.integers(0, W, (T, R))
    d = depth[np.arange(T)[:, None], h, w]
    key = jax.random.PRNGKey(2)
    noise = jax.random.normal(key, (T, R, M_GAUSS))
    xyz_j, z_j = jsamp.sample_points_on_rays(key, jnp.asarray(h), jnp.asarray(w), jnp.asarray(d),
                                             jnp.asarray(K), jnp.asarray(pose), N=N_STRAT,
                                             M=M_GAUSS, delta=0.1, min_dist=0.07, sigma=0.1)
    xyz_t, z_t = tsamp.sample_points_on_rays(_t(h), _t(w), _t(d), _t(K), _t(pose), N=N_STRAT,
                                             M=M_GAUSS, delta=0.1, min_dist=0.07, sigma=0.1,
                                             noise=_t(noise))
    np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), rtol=0, atol=1e-6)
    np.testing.assert_allclose(xyz_t.numpy(), np.asarray(xyz_j), rtol=0, atol=1e-5)


# (B, dims, C): the first is the volume of the decode's first tests; C = 1
# and 64 are the training target's TSDF and the PointNet `grid` plane
TRILINEAR_CASES = {"c3": (2, (6, 5, 4), 3), "c1": (1, (7, 3, 5), 1),
                   "c64": (1, (4, 6, 5), 64), "unit_axis": (2, (1, 5, 4), 5)}


@pytest.mark.parametrize("case", sorted(TRILINEAR_CASES))
def test_trilinear_interpolation(rng, case):
    """Points inside and outside the volume (border clamp), then on grid
    points (exact integer hits, as the dense decode's)."""
    B, dims, C = TRILINEAR_CASES[case]
    vol = rng.uniform(-1, 1, (B, *dims, C)).astype(np.float32)
    xyz = rng.uniform(-0.2, 0.8, (B, 50, 3)).astype(np.float32)  # some outside: border clamp
    origin = np.array([0.02, -0.01, 0.0], np.float32)
    idx = np.stack(np.meshgrid(*(np.arange(n) for n in dims), indexing="ij"), -1).reshape(-1, 3)
    step = np.array([0.1 * n / max(n - 1, 1) for n in dims], np.float32)
    hits = (idx[:20].astype(np.float32) * step + origin)[None].repeat(B, 0)
    xyz = np.concatenate([xyz, hits], axis=1)
    for mode in ("bilinear", "nearest"):
        ref = jinterp.trilinear_interpolation(jnp.asarray(vol), jnp.asarray(xyz), jnp.asarray(origin),
                                              0.1, mode)
        ours = tinterp.trilinear_interpolation(_t(vol), _t(xyz), _t(origin), 0.1, mode)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


def test_fuse_frames(batch):
    P, depth = batch["projection"][0], batch["depth"][0]
    ref = j_fuse_frames(VOXEL_DIM, 0.08, jnp.zeros(3), 0.24, jnp.asarray(P), jnp.asarray(depth))
    ours = fuse_frames(VOXEL_DIM, 0.08, torch.zeros(3), 0.24, _t(P), _t(depth))
    np.testing.assert_allclose(ours.tsdf.numpy(), np.asarray(ref.tsdf), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ours.weight.numpy(), np.asarray(ref.weight))
    vol = batch["vol_08_tsdf"][0, 0]
    assert vol.shape == VOXEL_DIM and (np.abs(vol) < 1).any() and (vol == 1).any()


def test_random_primitives_match_jax():
    for family in ("spheres", "boxes", "cylinders", "mixed", "rooms"):
        for seed in range(3):
            ours = random_primitives(np.random.default_rng(seed), family)
            ref = j_random_primitives(np.random.default_rng(seed), family)
            assert ours == ref
    with pytest.raises(ValueError, match="family"):
        random_primitives(np.random.default_rng(0), "tori")


# -- one step, three steps ------------------------------------------------------

def test_one_step_matches_jax_value_and_grad(jax_params, batch):
    """Loss, metrics and every parameter's gradient of one step; the step
    includes backfilled rays and scatter-max ties among ReLU zeros."""
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
    model = _model(jax_params)
    captured = {}
    model.pointnet.register_forward_pre_hook(lambda m, a: captured.__setitem__("p", a[0]))
    model.pointnet.blocks[0].register_forward_hook(
        lambda m, a, out: captured.__setitem__("net", out.detach()))
    loss, metrics = gen_nerf_forward_loss(model, batch_to_device(batch, "cpu"), draws=_draws(key))
    loss.backward()
    # the case holds ties: cells where two or more points pool a ReLU zero
    idx = coordinate2index(normalize_coordinate(captured["p"], 0.1, "xz"), 16)[0]
    zero = captured["net"][0, :, 0] == 0
    assert torch.bincount(idx[zero]).max() >= 2
    assert 0 < float(metrics["valid_coverage"].detach()) < 1
    assert set(metrics) == set(metrics_j)
    for k in metrics_j:
        np.testing.assert_allclose(float(metrics[k].detach()), float(metrics_j[k]), rtol=1e-5,
                                   atol=0)
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5, atol=0)
    ref = _grad_state(grads_j)
    named = dict(model.named_parameters())
    assert set(named) == set(ref)
    for name, p in named.items():
        g, r = p.grad.numpy(), ref[name].numpy()
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-4 * max(np.abs(r).max(), 1e-12),
                                   err_msg=name)


@pytest.mark.parametrize("clip", [None, 0.05])
def test_three_steps_match_jax(jax_params, batch, clip):
    """Three steps of the JAX train step against the port's, lr from the
    StepLR schedule per step (one batch an epoch); with clip 0.05 the
    global-norm clip triggers (the gradients' global norm is about 0.2)."""
    task = GenNerfTask(CFG, gradient_clip_val=clip)
    state = create_train_state({"params": jax.tree.map(jnp.asarray, jax_params)}, task.tx)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    model = _model(jax_params)
    opt = make_optimizer(model.parameters(), model.cfg.optimizer, clip)
    tb = batch_to_device(batch, "cpu")
    for epoch in range(3):
        key = jax.random.PRNGKey(100 + epoch)
        lr = j_lr_for_epoch(task.cfg.optimizer, task.cfg.scheduler, epoch)
        assert lr == lr_for_epoch(model.cfg.optimizer, model.cfg.scheduler, epoch)
        state = state.replace(opt_state=j_set_learning_rate(state.opt_state, lr))
        state, metrics_j = task.train_step(state, jbatch, key)
        set_learning_rate(opt, lr)
        metrics = train_step(model, opt, tb, draws=_draws(key))
        np.testing.assert_allclose(float(metrics["combined"]), float(metrics_j["combined"]),
                                   rtol=1e-4, atol=0)
    ref = gen_nerf_params_from_flax(jax.tree.map(np.asarray, state.params))
    lr0 = CFG["optimizer"]["lr"]
    diff = {name: np.abs(p.detach().numpy() - ref[name].numpy())
            for name, p in model.named_parameters()}
    for name, d in diff.items():
        assert d.max() <= 1e-1 * lr0, (name, d.max() / lr0)
    n_over = sum(int((d > 1e-2 * lr0).sum()) for d in diff.values())
    assert n_over <= 1e-3 * sum(d.size for d in diff.values()), n_over


# -- the port alone ---------------------------------------------------------------

def test_encode_is_differentiable(jax_params, batch):
    """A gradient reaches every PointNet and UNet parameter; predict and
    the no_grad encode build no graph."""
    model = _model(jax_params)
    tb = batch_to_device(batch, "cpu")
    loss, _ = gen_nerf_forward_loss(model, tb, draws=_draws(jax.random.PRNGKey(1)))
    loss.backward()
    for name, p in model.named_parameters():
        if name.startswith("pointnet."):
            assert p.grad is not None and p.grad.abs().max() > 0, name
    assert any(n.startswith("pointnet.unet.") for n, _ in model.named_parameters())
    with torch.no_grad():
        repr_ = model.encode(tb["projection"], tb["image"], tb["depth"], torch.Generator())
    assert all(not v.requires_grad for v in repr_.planes.values())
    vol = reconstruct(model, batch["projection"][0], batch["image"][0], batch["depth"][0],
                      generator=torch.Generator())
    assert vol.grad_fn is None and not vol.requires_grad


def test_flax_params_round_trip(jax_params):
    state = gen_nerf_params_from_flax(jax_params)
    tree = flax_params_from_gen_nerf(state)
    flat = jax.tree_util.tree_leaves_with_path(jax_params)
    assert len(flat) == len(jax.tree_util.tree_leaves(tree))
    for path, leaf in flat:
        node = tree
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, leaf, err_msg=str(path))
    back = gen_nerf_params_from_flax(tree)
    for k, v in state.items():
        assert torch.equal(back[k], v), k


def _fit(model, tmp, epochs, ckpt_path=None, batch=None):
    opt = make_optimizer(model.parameters(), model.cfg.optimizer, None)
    trainer = Trainer(model, opt, torch.Generator().manual_seed(0), str(tmp), max_epochs=epochs,
                      log_every_n_steps=1)
    trainer.fit([batch, batch], [batch], ckpt_path=ckpt_path)
    return trainer


def test_resume_is_bit_identical(jax_params, batch, tmp_path):
    """2 epochs straight against 1 epoch, save, resume into a fresh model
    and optimizer, 1 epoch: parameters bit-equal."""
    straight = _model(jax_params)
    _fit(straight, tmp_path / "a", 2, batch=batch)
    _fit(_model(jax_params), tmp_path / "b", 1, batch=batch)
    resumed = GenNerf(straight.cfg)  # a fresh random init, overwritten by the checkpoint
    trainer = _fit(resumed, tmp_path / "c", 2, ckpt_path=str(tmp_path / "b"), batch=batch)
    assert trainer.global_step == 4
    for (name, a), (_, b) in zip(straight.named_parameters(), resumed.named_parameters()):
        assert torch.equal(a, b), name
    info = load_checkpoint(str(tmp_path / "c" / "checkpoints" / "epoch_0001.pt"), GenNerf(straight.cfg))
    assert info == {"epoch": 1, "step": 4}
    rows = (tmp_path / "a" / "metrics.csv").read_text().splitlines()
    assert (rows[0].split(",")[:5] == ["data_wait_ms", "epoch", "lr", "step", "step_ms"]
            and len(rows) == 1 + 4 + 2)


def test_validation_keeps_training_draws(jax_params, batch, tmp_path):
    """Validation draws from its own generator: the same seed with
    validation after every epoch and after every second epoch trains to
    bit-equal parameters (before, epoch 1 drew from a generator that
    epoch 0's validation had moved on)."""
    models = []
    for every in (1, 2):
        model = _model(jax_params)
        opt = make_optimizer(model.parameters(), model.cfg.optimizer, None)
        trainer = Trainer(model, opt, torch.Generator().manual_seed(0), str(tmp_path / str(every)),
                          max_epochs=2, log_every_n_steps=1, check_val_every_n_epoch=every)
        trainer.fit([batch], [batch])
        assert "val_combined" in trainer.metrics
        models.append(model)
    for (name, a), (_, b) in zip(models[0].named_parameters(), models[1].named_parameters()):
        assert torch.equal(a, b), name


def test_fit_reads_the_loss_when_it_logs(jax_params, monkeypatch):
    """The loop leaves each step's metrics on the device until it logs: the
    third step's non-finite loss raises at the log of step 3, with the
    timings of all three steps filled."""
    from gennerf_tpu_torch.train import loop

    losses = iter([1.0, 2.0, float("nan"), 3.0])
    monkeypatch.setattr(loop, "train_step", lambda *a: {"combined": torch.tensor(next(losses))})
    model = _model(jax_params)
    trainer = Trainer(model, make_optimizer(model.parameters(), model.cfg.optimizer, None),
                      torch.Generator().manual_seed(0), None, log_every_n_steps=3)
    with pytest.raises(FloatingPointError, match="at step 3"):
        trainer.fit([{}] * 4)
    assert len(trainer.timings) == 3 and trainer.metrics == {}
    assert {"data_wait_ms", "step_ms"} == set(trainer.timings[0])


def test_render_cli_on_trained_params(tmp_path):
    """The render CLI renders the params.npz the train CLI writes: the
    trained head has a bias, which the point decode folds in."""
    from gennerf_tpu_torch.render import main as render_main

    shutil.copytree(os.path.join(REPO, "configs"), tmp_path / "configs")
    exp = tmp_path / "configs" / "experiment" / "tiny_train.yaml"
    exp.write_text(TINY_EXPERIMENT)
    out = tmp_path / "run"
    trainer = train_main(["--config", str(exp), "--out", str(out), "--epochs", "1",
                          "--synthetic", "--device", "cpu"])
    assert float(trainer.model.head_geo.fc.bias.detach()[0]) != 0.0
    frames = training_batch(1, 2, 24, 32, VOXEL_DIM, 0.08, seed=9)
    np.savez(tmp_path / "frames.npz", **{k: frames[k][0] for k in
                                         ("projection", "image", "depth", "intrinsics", "pose")})
    render_main(["--config", str(exp), "--params", str(out / "params.npz"),
                 "--frames", str(tmp_path / "frames.npz"), "--out", str(tmp_path / "views"),
                 "--num-views", "1", "--device", "cpu"])
    assert any(name.endswith(".png") for name in os.listdir(tmp_path / "views"))


def test_train_cli_then_predict_cli(tmp_path):
    """`python -m gennerf_tpu_torch.train` on a tiny experiment (synthetic
    batch from the seed, 2 epochs), then the predict CLI on its params."""
    shutil.copytree(os.path.join(REPO, "configs"), tmp_path / "configs")
    exp = tmp_path / "configs" / "experiment" / "tiny_train.yaml"
    exp.write_text(TINY_EXPERIMENT)
    out = tmp_path / "run"
    trainer = train_main(["--config", str(exp), "--out", str(out), "--epochs", "2",
                          "--synthetic", "--device", "cpu"])
    assert trainer.global_step == 2
    assert {"train_combined", "val_combined", "lr"} <= set(trainer.metrics)
    assert (out / "checkpoints" / "last.pt").exists() and (out / "metrics.csv").exists()
    frames = training_batch(1, 2, 24, 32, VOXEL_DIM, 0.08, seed=9)
    np.savez(tmp_path / "frames.npz", **{k: frames[k][0] for k in ("projection", "image", "depth")})
    predict_main(["--config", str(exp), "--params", str(out / "params.npz"),
                  "--frames", str(tmp_path / "frames.npz"), "--out", str(tmp_path / "tsdf.npz"),
                  "--device", "cpu"])
    trained = GenNerf(trainer.model.cfg)
    trained.load_state_dict(gen_nerf_params_from_flax(load_params_npz(str(out / "params.npz"))))
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(trained.state_dict()[k], v), k
    with np.load(tmp_path / "tsdf.npz") as f:
        vol = f["tsdf"]
    expect = reconstruct(trained.eval(), frames["projection"][0], frames["image"][0],
                         frames["depth"][0], generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(vol, expect.numpy())
    if not torch.cuda.is_available():  # the card is the default device
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_main(["--config", str(exp), "--out", str(tmp_path / "x"), "--synthetic"])


def test_eval_step_builds_no_graph(jax_params, batch):
    model = _model(jax_params)
    metrics = eval_step(model, batch_to_device(batch, "cpu"), draws=_draws(jax.random.PRNGKey(4)))
    assert all(v.grad_fn is None for v in metrics.values())
    assert all(p.grad is None for p in model.parameters())
