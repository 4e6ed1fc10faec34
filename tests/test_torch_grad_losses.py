"""The gradient losses and frustum supervision of the port on the CPU
against the JAX package, in float32: `GenNerf.decode_with_grad` (values and
d(tsdf)/d(xyz)), the eikonal and gradient loss terms (with and without a
mask, NaN bound gradients replaced by the normal), the eikonal gate,
`estimate_pointcloud_normals` and `bounds_pc_batch` (NaN positions equal),
the valid-pixel and frustum samplers and the frustum and `use_gradient`
supervision with the JAX draws injected, one eikonal, one frustum and one
`use_gradient` train step (loss, metrics and every gradient against
`jax.value_and_grad` of the JAX forward loss), an eikonal eval step, the
frustumN experiment read as JAX reads it (384 free, 128 near, 128 surface
points: its `N` and `M` keys are no fields), a bf16 eikonal step, and the
options that still raise.

Sizes are small (2 frames of 12x16, c_dim 8, H 32, 2 blocks, a 16x16x8
grid at 8 cm, 16 rays of 1 + 5 + 3 samples; frustum 24 free, 8 near and 8
surface points). Draws: (k_enc, k_sample) = split(key), (fps_key, k_pre) =
split(k_enc), (k_pix, k_pts) = split(k_sample); ray noise normal(k_pts);
frustum (k_free, k_noise) = split(k_pts), depths uniform(k_free, (BT,
N_free)), near noise normal(k_noise, (BT, N_near, 3)).

Tolerances: sampled points, normals, bounds and loss terms within 1e-5 of
their largest magnitude (1e-6 for the loss terms); decode_with_grad's
gradient within 1e-5 of its largest magnitude; a step's loss and metrics
within 1e-5 relative, every gradient within 1e-4 of its tensor's largest
magnitude (the test_torch_train bound: float32 through encode, decode, the
double backward and the loss in another summation order).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gennerf_tpu import ops as jops
from gennerf_tpu.models import losses as jl
from gennerf_tpu.models.config import GenNerfConfig as JConfig
from gennerf_tpu.models.config import LossConfig as JLossConfig
from gennerf_tpu.models.config import config_from_dict as j_config_from_dict
from gennerf_tpu.models.gen_nerf import GenNerf as JGenNerf
from gennerf_tpu.train.step import gen_nerf_forward_loss as j_forward_loss
from gennerf_tpu.train.step import sample_supervision_points as j_sample_supervision
from gennerf_tpu.train.tasks import GenNerfTask
from gennerf_tpu_torch.data.synthetic import training_batch
from gennerf_tpu_torch.models import losses as tl
from gennerf_tpu_torch.models.config import (
    GenNerfConfig, LossConfig, check_supported, config_from_dict,
)
from gennerf_tpu_torch.models.gen_nerf import GenNerf, SceneRepr
from gennerf_tpu_torch.ops import sampling as tsamp
from gennerf_tpu_torch.ops.normals import estimate_pointcloud_normals
from gennerf_tpu_torch.ops.projection import get_3d_points
from gennerf_tpu_torch.train.state import make_optimizer
from gennerf_tpu_torch.train.step import (
    StepDraws, batch_to_device, eval_step, gen_nerf_forward_loss, sample_supervision_points,
    train_step,
)
from gennerf_tpu_torch.utils.config import load_experiment_model_config
from gennerf_tpu_torch.utils.port_params import gen_nerf_params_from_flax

import _torch_threads  # noqa: F401  (sizes torch's threads per xdist worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOXEL_DIM = (16, 16, 8)
T, H, W = 2, 12, 16
R, N_STRAT, M_GAUSS = 16, 5, 3
FRUSTUM = {"N_free": 24, "N_near": 8, "N_surf": 8, "sigma": 0.05, "d_min": 0.3, "d_max": 2.5}
BASE = {
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
    "frustum": FRUSTUM,
    "loss": {"use_tsdf": True, "tsdf": {"weight": 1.0, "transform": "smooth_log",
                                        "shift": 15.0, "smoothness": 10.0},
             "eikonal": {"weight": 0.3, "apply_distance": 0.2}, "gradient": {"weight": 0.5}},
    "optimizer": {"type": "Adam", "lr": 0.001, "weight_decay": 0.0001},
}


def _cfg(mode="ray", eikonal=False, gradient=False) -> dict:
    loss = dict(BASE["loss"], use_eikonal=eikonal, use_gradient=gradient)
    return dict(BASE, sampling_mode=mode, loss=loss)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(ours, ref, rel=1e-5, name=""):
    o = ours.detach().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    r = np.asarray(ref)
    np.testing.assert_array_equal(np.isnan(o), np.isnan(r), err_msg=name)
    ok = ~np.isnan(r)
    scale = max(float(np.abs(r[ok]).max()) if ok.any() else 0.0, 1e-12)
    np.testing.assert_allclose(o[ok], r[ok], rtol=0, atol=rel * scale, err_msg=name)


@pytest.fixture(autouse=True)
def _f32_highest():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture(scope="module")
def batch():
    """One scene of 2 frames; the second keeps 30 valid depth pixels, so
    the frustum's surface and near points are partly backfilled."""
    b = training_batch(1, T, H, W, VOXEL_DIM, 0.08, seed=3)
    keep = np.zeros((H, W), bool)
    keep[3:8, 4:10] = True
    b["depth"][0, 1] = np.where(keep, b["depth"][0, 1], 0.0)
    return b


@pytest.fixture(scope="module")
def params(batch):
    """The JAX model's params with every zero-init fc_1 randomized."""
    task = GenNerfTask(_cfg())
    variables = jax.jit(task.model.init, static_argnums=(6,))(
        jax.random.PRNGKey(0), *(jnp.asarray(batch[k]) for k in ("projection", "image", "depth")),
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


def _model(tree, cfg: dict, dtype=torch.float32) -> GenNerf:
    model = GenNerf(config_from_dict(GenNerfConfig, cfg), dtype=dtype)
    model.load_state_dict(gen_nerf_params_from_flax(tree))
    return model


def _draws(key, cfg: dict, BT=T, npix=H * W, presample=64) -> StepDraws:
    """The JAX step's draws from `key` in the config's sampling mode."""
    k_enc, k_sample = jax.random.split(key)
    fps_key, k_pre = jax.random.split(k_enc)
    k_pix, k_pts = jax.random.split(k_sample)
    draws = StepDraws(sel=_t(jax.random.randint(k_pre, (BT, presample), 0, npix)),
                      start=_t(jax.random.randint(fps_key, (BT,), 0, presample)),
                      scores=_t(jax.random.uniform(k_pix, (BT, npix))))
    if cfg.get("sampling_mode", "ray") == "frustum":
        f = cfg["frustum"]
        k_free, k_noise = jax.random.split(k_pts)
        return draws._replace(
            frustum_u=_t(jax.random.uniform(k_free, (BT, f["N_free"]))),
            near_noise=_t(jax.random.normal(k_noise, (BT, f["N_near"], 3))))
    return draws._replace(noise=_t(jax.random.normal(k_pts, (BT, R, M_GAUSS))))


# -- decode_with_grad -----------------------------------------------------------

def test_decode_with_grad_matches_jax(params, batch, rng):
    """Outputs and d(tsdf)/d(xyz) at points in and around the volume,
    decoding the JAX scene; the gradient is the same with and without
    autograd around the call (detached under no_grad)."""
    task = GenNerfTask(_cfg())
    key = jax.random.PRNGKey(3)
    repr_j = jax.jit(lambda: task.model.apply(
        {"params": params}, *(jnp.asarray(batch[k]) for k in ("projection", "image", "depth")),
        key, VOXEL_DIM, jnp.zeros(3), method=JGenNerf.encode))()
    xyz = rng.uniform(-0.2, 1.4, (1, 90, 3)).astype(np.float32)
    ref = jax.jit(lambda r, p: task.model.apply({"params": params}, r, p, jnp.zeros(3),
                                                method=JGenNerf.decode_with_grad))(
        repr_j, jnp.asarray(xyz))
    model = _model(params, _cfg())
    scene = SceneRepr({k: _t(v) for k, v in repr_j.planes.items()})
    out = model.decode_with_grad(scene, _t(xyz))
    assert out["grad"].requires_grad and out["grad"].shape == (1, 90, 3)
    for k in ("tsdf", "feat_geo", "grad"):
        _close(out[k], ref[k], name=k)
    assert float(np.abs(np.asarray(ref["grad"])).max()) > 0.1
    with torch.no_grad():
        detached = model.decode_with_grad(scene, _t(xyz))
    assert not detached["grad"].requires_grad
    torch.testing.assert_close(detached["grad"], out["grad"].detach(), rtol=0, atol=0)


# -- loss terms -----------------------------------------------------------------

def _loss_inputs(rng, with_nan: bool):
    B, S = 3, 1 + N_STRAT + M_GAUSS
    grad = rng.standard_normal((B, R * S, 3)).astype(np.float32)
    grad[0, :5] = 0.0  # zero gradients: the safe norm's case
    tsdf_t = rng.uniform(-1.0, 1.0, (B, R * S, 1)).astype(np.float32)
    tsdf_t[1, :20] = 1.0
    normals = rng.standard_normal((B, R, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    grad_vec = rng.standard_normal((B, R, S - 1, 3)).astype(np.float32)
    if with_nan:
        grad_vec[0, 2, 1] = np.nan
        grad_vec[2, 5, :] = np.nan
    valid = (rng.uniform(size=(B, R * S, 1)) > 0.3).astype(np.float32)
    return grad, tsdf_t, normals, grad_vec, valid


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("terms", [("use_eikonal",), ("use_gradient",),
                                   ("use_eikonal", "use_gradient", "use_isdf")])
def test_grad_loss_terms(rng, terms, masked):
    """calculate_loss with the eikonal and gradient terms: each term, the
    combined loss and the gradients with respect to every output."""
    grad, tsdf_t, normals, grad_vec, valid = _loss_inputs(rng, with_nan=True)
    pred = rng.uniform(-1.0, 1.0, tsdf_t.shape).astype(np.float32)
    flags = {t: True for t in terms}
    cfg_d = {**flags, "eikonal": {"weight": 0.3, "apply_distance": 0.2},
             "gradient": {"weight": 0.5}}
    outputs = {"tsdf": pred, "grad": grad}
    targets = {"tsdf": tsdf_t, "sampled_normals": normals, "grad_vec": grad_vec}
    if masked:
        targets["valid"] = valid

    def jloss(o):
        return jl.calculate_loss(j_config_from_dict(JLossConfig, cfg_d), o,
                                 {k: jnp.asarray(v) for k, v in targets.items()}, num_rays=R)

    (ref, ref_terms), ref_grads = jax.value_and_grad(jloss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in outputs.items()})
    out_t = {k: _t(v).requires_grad_() for k, v in outputs.items()}
    loss, losses = tl.calculate_loss(config_from_dict(LossConfig, cfg_d), out_t,
                                     {k: _t(v) for k, v in targets.items()}, num_rays=R)
    loss.backward()
    assert set(losses) == set(ref_terms)
    for k in ref_terms:
        _close(losses[k], ref_terms[k], 1e-6, k)
    for k in outputs:
        _close(out_t[k].grad, ref_grads[k], 1e-5, k)


def test_eikonal_gate(rng):
    """Zero below apply_distance, |norm - 1| at and above it."""
    cfg = config_from_dict(LossConfig, {"eikonal": {"apply_distance": 0.5}})
    grad = _t(np.array([[[3.0, 4.0, 0.0], [0.0, 0.0, 0.5], [0.0, 0.0, 0.0]]], np.float32))
    tsdf = _t(np.array([[[0.5], [0.4], [1.0]]], np.float32))
    m = tl.loss_eikonal(cfg, {"grad": grad}, {"tsdf": tsdf})
    torch.testing.assert_close(m, _t(np.array([[[4.0], [0.0], [1.0]]], np.float32)))


# -- normals, bounds, samplers ------------------------------------------------------

def test_estimate_pointcloud_normals(batch):
    """On the batch's unprojected depth maps with some points NaN (a hole,
    a row and the second frame's invalid pixels) and one frame all NaN."""
    pts = np.asarray(jops.get_3d_points(jnp.asarray(batch["depth"][0]),
                                        jnp.asarray(batch["projection"][0])))
    pts = np.concatenate([pts, np.full_like(pts[:1], np.nan)])
    pts[0, 4:6, 5:9] = np.nan
    pts[0, 9] = np.nan
    pts[1][batch["depth"][0, 1] == 0] = np.nan
    ref = jax.vmap(jops.estimate_pointcloud_normals)(jnp.asarray(pts))
    ours = estimate_pointcloud_normals(_t(pts))
    _close(ours, ref)
    assert np.isnan(np.asarray(ref)).any() and not np.isnan(np.asarray(ref)).all()
    _close(estimate_pointcloud_normals(_t(pts[0])), ref[0])


def test_bounds_pc_batch(rng):
    """Bounds and gradients; a sample on its nearest surface point (a
    Gaussian sample of zero noise) has a NaN gradient in both."""
    B, S = 2, 1 + N_STRAT + M_GAUSS
    pc = rng.uniform(0.0, 2.0, (B, R, S, 3)).astype(np.float32)
    pc[0, 3, S - 1] = pc[0, 3, 0]
    pc[1, 7, 2] = pc[1, 2, 0]
    z = rng.uniform(0.1, 3.0, (B, R, S)).astype(np.float32)
    depth = rng.uniform(0.5, 2.5, (B, R)).astype(np.float32)
    rb, rg = jops.bounds_pc_batch(jnp.asarray(pc), jnp.asarray(z), jnp.asarray(depth))
    ob, og = tsamp.bounds_pc_batch(_t(pc), _t(z), _t(depth))
    _close(ob, rb)
    _close(og, rg)
    assert np.isnan(np.asarray(rg)).sum() == 6


def test_sample_valid_pixels(batch, rng):
    depth = batch["depth"][0].copy()
    normals = rng.standard_normal((T, H, W, 3)).astype(np.float32)
    normals[0, :3] = np.nan
    scores = rng.uniform(size=(T, H * W)).astype(np.float32)
    key = jax.random.PRNGKey(1)
    ref = jops.sample_valid_pixels(key, jnp.asarray(depth), jnp.asarray(normals), 50)
    ours = tsamp.sample_valid_pixels(_t(depth), _t(normals), 50,
                                     scores=_t(jax.random.uniform(key, (T, H * W))))
    ok = np.asarray(ref[3])
    np.testing.assert_array_equal(ours[3].numpy(), ok)
    # the valid picks come first, in score order; backfilled ties may differ
    for o, r in zip(ours[1:3], ref[1:3]):
        np.testing.assert_array_equal(o.numpy()[ok], np.asarray(r)[ok])
    assert not ok[1].all() and ok[0].all()


def test_sample_points_in_frustum(batch, rng):
    intr = batch["intrinsics"][0]
    pose = batch["pose"][0]
    h = rng.integers(0, H, (T, 30))
    w = rng.integers(0, W, (T, 30))
    key = jax.random.PRNGKey(2)
    ref_xyz, ref_z = jops.sample_points_in_frustum(key, jnp.asarray(h), jnp.asarray(w),
                                                   jnp.asarray(intr), jnp.asarray(pose), 0.5, 2.0)
    xyz, z = tsamp.sample_points_in_frustum(_t(h), _t(w), _t(intr), _t(pose), 0.5, 2.0,
                                            u=_t(jax.random.uniform(key, (T, 30))))
    _close(z, ref_z)
    _close(xyz, ref_xyz)
    assert float(z.min()) >= 0.5 and float(z.max()) <= 2.0


@pytest.mark.parametrize("mode,gradient", [("frustum", False), ("ray", True)])
def test_supervision_points_match_jax(batch, mode, gradient):
    """The frustum points and their validity; the use_gradient rays with
    their sampled normals and negated bound gradients."""
    cfg_d = _cfg(mode, gradient=gradient)
    key = jax.random.PRNGKey(8)
    _, k_sample = jax.random.split(key)
    ref = j_sample_supervision(j_config_from_dict(JConfig, cfg_d),
                               {k: jnp.asarray(v) for k, v in batch.items()}, k_sample)
    ours = sample_supervision_points(config_from_dict(GenNerfConfig, cfg_d),
                                     batch_to_device(batch, "cpu"), draws=_draws(key, cfg_d))
    assert ours["points_per_frame"] == ref["points_per_frame"]
    _close(ours["valid"], ref["valid"], name="valid")
    # backfilled (invalid) pixels may differ in tie order: compare the valid points
    ok = np.asarray(ref["valid"])[..., 0] > 0
    _close(ours["xyz"][torch.from_numpy(ok)], np.asarray(ref["xyz"])[ok], name="xyz")
    if gradient:
        _close(ours["sampled_normals"], ref["sampled_normals"], name="sampled_normals")
        # a unit vector from a surface sample to a sample d away turns by
        # about (the points' float32 difference) / d: held to 2e-6 / d
        surf = np.asarray(ref["xyz"]).reshape(T, R, -1, 3)
        dist = np.asarray(jops.bounds_pc_batch(jnp.asarray(surf), jnp.zeros(surf.shape[:3]),
                                               jnp.zeros((T, R)))[0])[:, :, 1:]
        err = np.abs(ours["grad_vec"].numpy() - np.asarray(ref["grad_vec"])).max(-1)
        assert (err <= 1e-5 + 2e-6 / np.abs(dist)).all(), err.max()
    # frame 1's 30 valid pixels: enough for the 16 rays, not for the 40 frustum pixels
    assert (float(ours["valid"].mean()) < 1) == (mode == "frustum")


def test_frustum_n_config_reads_as_jax():
    """train_tsdf_one_scene_seqs1_framesN sets frustum.N and M, which are no
    fields: both packages sample 384 free, 128 near and 128 surface points
    with sigma 0 between 0.5 and 2 m."""
    path = os.path.join(REPO, "configs", "experiment", "train_tsdf_one_scene_seqs1_framesN.yaml")
    d = load_experiment_model_config(path)
    assert d["frustum"]["N"] == 512 and d["frustum"]["M"] == 1
    ours = config_from_dict(GenNerfConfig, d)
    ref = j_config_from_dict(JConfig, d)
    assert dataclasses.asdict(ours.frustum) == dataclasses.asdict(ref.frustum) == {
        "N_free": 384, "N_near": 128, "N_surf": 128, "sigma": 0.0, "d_min": 0.5, "d_max": 2.0}
    assert ours.sampling_mode == ref.sampling_mode == "frustum"
    check_supported(ours)


# -- steps ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,eikonal,gradient", [
    ("ray", True, False), ("frustum", False, False), ("ray", False, True),
    ("frustum", True, False)], ids=["eikonal", "frustum", "gradient", "frustum_eikonal"])
def test_step_matches_jax(params, batch, mode, eikonal, gradient):
    """Loss, metrics and every parameter's gradient of one train step
    against jax.value_and_grad of the JAX forward loss (the double backward
    of the gradient losses included). The gradient case scales the head's
    weight by 0.1: where a sample's tanh saturates, |d tsdf/d xyz| falls
    below the reference cosine's 1e-6 clamp and its cosine is float32 noise
    in either framework (torch's and XLA's tanh part by an ulp near +-1,
    its derivative 0 against 1.2e-7), so each such sample's loss could
    differ by up to 1; the scaled head saturates nowhere."""
    cfg_d = _cfg(mode, eikonal, gradient)
    if gradient:
        params = jax.tree.map(np.copy, params)
        params["head_geo"]["Dense_0"]["kernel"] *= 0.1
    task = GenNerfTask(cfg_d)
    key = jax.random.PRNGKey(11)

    @jax.jit
    def jstep(p, b):
        def f(p_):
            loss, metrics, _ = j_forward_loss(task.model, task.cfg, p_, {}, b, key, VOXEL_DIM, True)
            return loss, metrics
        return jax.value_and_grad(f, has_aux=True)(p)

    (loss_j, metrics_j), grads_j = jstep(jax.tree.map(jnp.asarray, params),
                                         {k: jnp.asarray(v) for k, v in batch.items()})
    model = _model(params, cfg_d)
    loss, metrics = gen_nerf_forward_loss(model, batch_to_device(batch, "cpu"),
                                          draws=_draws(key, cfg_d))
    loss.backward()
    assert set(metrics) == set(metrics_j)
    assert ("eikonal" in metrics) == eikonal and ("gradient" in metrics) == gradient
    for k in metrics_j:
        np.testing.assert_allclose(float(metrics[k].detach()), float(metrics_j[k]), rtol=1e-5,
                                   atol=1e-8, err_msg=k)
    assert all(float(metrics_j[k]) > 0 for k in ("eikonal", "gradient") if k in metrics_j)
    ref = gen_nerf_params_from_flax(jax.tree.map(np.asarray, grads_j))
    for name, p in model.named_parameters():
        r = ref[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), r, rtol=0,
                                   atol=1e-4 * max(np.abs(r).max(), 1e-12), err_msg=name)


def test_eikonal_eval_step_matches_jax(params, batch):
    """The eval step computes the eikonal term too (under no_grad)."""
    cfg_d = _cfg("ray", eikonal=True)
    task = GenNerfTask(cfg_d)
    key = jax.random.PRNGKey(12)
    _, metrics_j, _ = jax.jit(lambda p, b: j_forward_loss(
        task.model, task.cfg, p, {}, b, key, VOXEL_DIM, False))(
        jax.tree.map(jnp.asarray, params), {k: jnp.asarray(v) for k, v in batch.items()})
    metrics = eval_step(_model(params, cfg_d), batch_to_device(batch, "cpu"),
                        draws=_draws(key, cfg_d))
    assert not any(v.requires_grad for v in metrics.values())
    for k in metrics_j:
        np.testing.assert_allclose(float(metrics[k]), float(metrics_j[k]), rtol=1e-5, err_msg=k)


def test_eikonal_step_bf16(params, batch):
    """An eikonal train step in bf16-mixed: the gradient of a bf16 TSDF
    (a bf16 ones cotangent) is float32, every term finite and positive, the
    loss within 2e-2 of the float32 step's, the state float32."""
    cfg_d = _cfg("ray", eikonal=True, gradient=False)
    draws = _draws(jax.random.PRNGKey(13), cfg_d)
    tb = batch_to_device(batch, "cpu")
    m16 = _model(params, cfg_d, torch.bfloat16)
    with torch.no_grad():
        loss32 = float(gen_nerf_forward_loss(_model(params, cfg_d).train(), tb, draws=draws)[0])
    out = m16.decode_with_grad(m16.encode(tb["projection"], tb["image"], tb["depth"], sel=draws.sel,
                                          start=draws.start), tb["pose"][:, :, :3, 3])
    assert out["tsdf"].dtype == torch.bfloat16 and out["grad"].dtype == torch.float32
    opt = make_optimizer(m16.parameters(), m16.cfg.optimizer)
    metrics = train_step(m16, opt, tb, draws=draws)
    assert all(np.isfinite(float(v)) for v in metrics.values()) and float(metrics["eikonal"]) > 0
    assert abs(float(metrics["combined"]) - loss32) <= 2e-2 * abs(loss32)
    assert all(v.dtype == torch.float32 for v in m16.state_dict().values())


@pytest.mark.parametrize("override", [
    {"loss": {"use_distill": True}, "teacher": {"type": "clip"}},
    {"sampling_mode": "frustum", "loss": {"use_gradient": True}},
    {"sampling_mode": "grid"}])
def test_options_still_unported_raise(override):
    cfg = dict(BASE, **{k: dict(BASE.get(k, {}), **v) if isinstance(v, dict) else v
                        for k, v in override.items()})
    with pytest.raises(NotImplementedError):
        GenNerf(config_from_dict(GenNerfConfig, cfg))
