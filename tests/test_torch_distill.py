"""Semantic distillation of the port on the CPU against the JAX package, in
float32: the random-projection teacher (its filters and features, at a
width that is and one that is not a multiple of the stride, where XLA's
"SAME" padding is asymmetric), `sample_teacher_features`, `loss_distill`
(cosine and l2, with and without a mask), `calculate_loss` with the
distillation term and `distill_coverage`, the surface-mode forward loss
and one train step's gradients against `jax.value_and_grad`, the
surface-mode eval step, the `use_auxiliary` encode (the teacher alone
beside the planes, and the spatial encoder plus the teacher under
frame_chunk and remat, forward and backward), the two cases where the
reference adds no term (teacher 'none'; surface mode under frustum
sampling), both distillation experiments read as JAX reads them, and the
dense and rendered decode of a `use_auxiliary` scene, which takes neither
the grid-decode nor the point-decode kernel. Render mode is in
test_torch_distill_render.py.

Sizes are small (2 frames of 30x41, c_dim 8, 16x16 planes, H 32, 2
blocks, teacher feature_dim 8 at patch 8 / stride 4, a 16x16x8 grid at 8
cm, 16 rays of 1 + 5 + 3 samples). Draws: the JAX step's key splits
injected as StepDraws (see test_torch_grad_losses.py).

Tolerances: the teacher's filters exactly equal; features, sampled
features, volumes and loss terms within 1e-5 of their largest magnitude
(1e-6 for the loss terms and their gradients with respect to the
outputs, 1e-5 for those); a step's loss and metrics within 1e-5
relative; every parameter gradient within 1e-4 of its tensor's largest
magnitude (float32 through encode, decode and the loss in another
summation order: the test_torch_train bound).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gennerf_tpu.models import losses as jl
from gennerf_tpu.models import teacher as jteacher
from gennerf_tpu.models.config import GenNerfConfig as JConfig
from gennerf_tpu.models.config import LossConfig as JLossConfig
from gennerf_tpu.models.config import config_from_dict as j_config_from_dict
from gennerf_tpu.models.gen_nerf import GenNerf as JGenNerf
from gennerf_tpu.train.step import gen_nerf_forward_loss as j_forward_loss
from gennerf_tpu.train.tasks import GenNerfTask
from gennerf_tpu_torch.data.synthetic import training_batch
from gennerf_tpu_torch.models import losses as tl
from gennerf_tpu_torch.models import teacher as tteacher
from gennerf_tpu_torch.models.config import (
    GenNerfConfig, LossConfig, check_supported, config_from_dict,
)
from gennerf_tpu_torch.models.gen_nerf import GenNerf
from gennerf_tpu_torch.models.spatial_encoder import spatial_latent_size
from gennerf_tpu_torch.predict import build_model, reconstruct
from gennerf_tpu_torch.render import render_views
from gennerf_tpu_torch.train import predict as tpred
from gennerf_tpu_torch.train.step import (
    StepDraws, batch_to_device, eval_step, gen_nerf_forward_loss,
)
from gennerf_tpu_torch.train.tasks import GenNerfTask as TTask
from gennerf_tpu_torch.utils.config import load_experiment_model_config
from gennerf_tpu_torch.utils.port_params import gen_nerf_params_from_flax

import _torch_threads  # noqa: F401  (sizes torch's threads per xdist worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOXEL_DIM = (16, 16, 8)
VS = 0.08
T, H, W = 2, 30, 41
R, N_STRAT, M_GAUSS = 16, 5, 3
C_TEACHER = 8
POINTNET = {"num_sparse_points": 32, "fps_presample": 64, "normalize_coords": True, "c_dim": 8,
            "hidden_dim": 8, "plane_resolution": 16, "n_blocks": 2, "unet": True,
            "unet_kwargs": {"depth": 2, "merge_mode": "concat", "start_filts": 8}}
BASE = {
    "type": "GenNerf", "voxel_size": VS, "voxel_dim_train": list(VOXEL_DIM),
    "voxel_dim_val": list(VOXEL_DIM), "voxel_dim_test": list(VOXEL_DIM),
    "encoder": {"use_spatial": False, "use_pointnet": True, "pointnet": POINTNET},
    "mlp": {"d_out_sem": C_TEACHER, "d_out_geo": 8, "n_blocks": 2, "d_hidden": 32, "alpha": 0.7},
    "code": {"num_freqs": 6, "freq_factor": 0.5, "include_input": True},
    "ray": {"num_rays": R, "N": N_STRAT, "M": M_GAUSS},
    "frustum": {"N_free": 24, "N_near": 8, "N_surf": 8, "sigma": 0.05, "d_min": 0.3,
                "d_max": 2.5},
    "teacher": {"type": "random_projection", "feature_dim": C_TEACHER, "seed": 3},
    "loss": {"use_tsdf": True, "tsdf": {"weight": 1.0, "transform": "smooth_log",
                                        "shift": 15.0, "smoothness": 10.0},
             "use_distill": True, "distill": {"weight": 0.5, "metric": "cosine"}},
    "optimizer": {"type": "Adam", "lr": 0.001, "weight_decay": 0.0001},
}


def cfg_dict(mode="surface", metric="cosine", sampling="ray", teacher="random_projection",
             auxiliary=False, spatial=None, warmstart=True, **distill):
    """The test's model config: distillation in `mode`, optionally the
    teacher's features in the volume (auxiliary) and a spatial encoder."""
    enc = dict(BASE["encoder"])
    if auxiliary:
        enc.update(use_auxiliary=True, auxiliary_dim=C_TEACHER)
    if spatial is not None:
        enc.update(use_spatial=True, spatial=spatial)
    loss = dict(BASE["loss"], distill=dict(BASE["loss"]["distill"], mode=mode, metric=metric,
                                           gt_warmstart=warmstart, **distill))
    return dict(BASE, encoder=enc, sampling_mode=sampling, loss=loss,
                teacher=dict(BASE["teacher"], type=teacher))


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(ours, ref, rel=1e-5, name=""):
    o = ours.detach().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    r = np.asarray(ref)
    assert o.shape == r.shape, (name, o.shape, r.shape)
    scale = max(float(np.abs(r).max()), 1e-12)
    np.testing.assert_allclose(o, r, rtol=0, atol=rel * scale, err_msg=name)


@pytest.fixture(autouse=True)
def _f32_highest():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture(scope="module")
def full_batch():
    """One scene of 2 frames of 30x41, each with more valid depth pixels
    than any test samples (no backfill)."""
    b = training_batch(1, T, H, W, VOXEL_DIM, VS, seed=3)
    assert (b["depth"] > 0).sum(axis=(2, 3)).min() > 100
    return b


@pytest.fixture(scope="module")
def batch(full_batch):
    """The scene with 10 valid depth pixels left in its second frame, so 6
    of that frame's 16 rays are backfilled and masked. (Backfilled pixels
    tie at -inf, and torch's top-k may order them otherwise than XLA's:
    a test whose result reads them, the frustum's always-valid free
    points or the render hit rate, takes the full batch.)"""
    b = {k: v.copy() for k, v in full_batch.items()}
    keep = np.zeros(H * W, bool)
    keep[np.flatnonzero(b["depth"][0, 1] > 0)[::37][:10]] = True
    b["depth"][0, 1] = np.where(keep.reshape(H, W), b["depth"][0, 1], 0.0)
    assert (b["depth"][0, 1] > 0).sum() == 10
    return b


def jax_params(cfg: dict, batch, seed=5):
    """The JAX model's params (and batch statistics) with every zero-init
    Dense_1 and, with a spatial encoder, every BatchNorm drawn at random."""
    task = GenNerfTask(cfg)
    variables = jax.jit(task.model.init, static_argnums=(6,))(
        jax.random.PRNGKey(0), *(jnp.asarray(batch[k]) for k in ("projection", "image", "depth")),
        jnp.zeros((1, 8, 3)), jax.random.PRNGKey(0), VOXEL_DIM, jnp.zeros(3))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda a: np.array(a, np.float32), dict(variables["params"]))
    stats = jax.tree.map(lambda a: np.array(a, np.float32),
                         dict(variables.get("batch_stats", {})))

    def walk(p, s):
        for k, v in p.items():
            if not isinstance(v, dict):
                continue
            if "scale" in v:
                v["scale"] = rng.uniform(0.5, 1.5, v["scale"].shape).astype(np.float32)
                v["bias"] = (0.1 * rng.standard_normal(v["bias"].shape)).astype(np.float32)
                s[k]["mean"] = (0.1 * rng.standard_normal(s[k]["mean"].shape)).astype(np.float32)
                s[k]["var"] = rng.uniform(0.5, 2.0, s[k]["var"].shape).astype(np.float32)
            elif k == "Dense_1":
                v["kernel"] = (0.2 * rng.standard_normal(v["kernel"].shape)).astype(np.float32)
                v["bias"] = (0.1 * rng.standard_normal(v["bias"].shape)).astype(np.float32)
            else:
                walk(v, s.get(k, {}))

    walk(params, stats)
    params["mlp"]["alpha"] = np.asarray(0.7, np.float32)
    return task, params, stats


def port_model(cfg: dict, params, stats=None) -> GenNerf:
    model = TTask.build(config_from_dict(GenNerfConfig, cfg))
    model.load_state_dict(gen_nerf_params_from_flax(params, stats or None))
    return model


def step_draws(key, cfg: dict, BT=T, npix=H * W, presample=64) -> StepDraws:
    """The JAX step's draws from `key`: (k_enc, k_sample) = split(key),
    (fps_key, k_pre) = split(k_enc), (k_pix, k_pts) = split(k_sample), the
    render pixels' scores uniform(fold_in(k_sample, 7))."""
    k_enc, k_sample = jax.random.split(key)
    fps_key, k_pre = jax.random.split(k_enc)
    k_pix, k_pts = jax.random.split(k_sample)
    draws = StepDraws(sel=_t(jax.random.randint(k_pre, (BT, presample), 0, npix)),
                      start=_t(jax.random.randint(fps_key, (BT,), 0, presample)),
                      scores=_t(jax.random.uniform(k_pix, (BT, npix))),
                      render_scores=_t(jax.random.uniform(jax.random.fold_in(k_sample, 7),
                                                          (BT, npix))))
    if cfg.get("sampling_mode", "ray") == "frustum":
        f = cfg["frustum"]
        k_free, k_noise = jax.random.split(k_pts)
        return draws._replace(
            frustum_u=_t(jax.random.uniform(k_free, (BT, f["N_free"]))),
            near_noise=_t(jax.random.normal(k_noise, (BT, f["N_near"], 3))))
    return draws._replace(noise=_t(jax.random.normal(k_pts, (BT, R, M_GAUSS))))


def jax_loss_and_grads(task, params, stats, batch, key, train=True):
    @jax.jit
    def run(p, b):
        def f(p_):
            loss, metrics, _ = j_forward_loss(task.model, task.cfg, p_, stats, b, key, VOXEL_DIM,
                                              train)
            return loss, metrics
        return jax.value_and_grad(f, has_aux=True)(p)

    (_, metrics), grads = run(jax.tree.map(jnp.asarray, params),
                              {k: jnp.asarray(v) for k, v in batch.items()})
    return {k: float(v) for k, v in metrics.items()}, grads


def check_step(model, metrics, metrics_j, grads_j=None):
    """Metrics within 1e-5 relative; every parameter gradient within 1e-4
    of its tensor's largest magnitude."""
    assert set(metrics) == set(metrics_j), (sorted(metrics), sorted(metrics_j))
    for k, v in metrics_j.items():
        np.testing.assert_allclose(float(metrics[k].detach()), v, rtol=1e-5, atol=1e-8, err_msg=k)
    if grads_j is None:
        return
    ref = gen_nerf_params_from_flax(jax.tree.map(np.asarray, grads_j))
    for name, p in model.named_parameters():
        r = ref[name].numpy()
        got = p.grad.numpy() if p.grad is not None else np.zeros_like(r)
        np.testing.assert_allclose(got, r, rtol=0, atol=1e-4 * max(np.abs(r).max(), 1e-12),
                                   err_msg=name)


# -- teacher -----------------------------------------------------------------------

@pytest.mark.parametrize("width", [40, 41], ids=["w40", "w41_asymmetric_same"])
def test_teacher_matches_jax(rng, width):
    """Filters bit-equal (one numpy stream); features at 30 x width, where
    W = 41 pads XLA's "SAME" 3 left and 4 right at stride 4 and patch 8."""
    images = rng.uniform(0.0, 1.0, (3, 3, 30, width)).astype(np.float32)
    ref = jteacher.RandomProjectionTeacher(feature_dim=16, patch=8, stride=4, seed=7)
    ours = tteacher.RandomProjectionTeacher(16, 8, 4, 7)
    np.testing.assert_array_equal(ours.filters.numpy(), np.asarray(ref._filters))
    assert tteacher.same_padding(width, 8, 4) == ((2, 2) if width == 40 else (3, 4))
    out_j = ref(jnp.asarray(images))
    out = ours(_t(images))
    assert out.shape == (3, 16, 8, -(-width // 4))
    _close(out, out_j, name="features")
    assert "filters" not in ours.state_dict()
    assert float(np.abs(np.asarray(out_j)).max()) > 0.05


def test_sample_teacher_features(rng):
    fmap = rng.standard_normal((2, 5, 8, 11)).astype(np.float32)
    h = rng.integers(0, 30, (2, 50))
    w = rng.integers(0, 41, (2, 50))
    h[0, :3], w[0, :3] = (0, 29, 29), (0, 40, 0)  # the image's corners
    ref = jteacher.sample_teacher_features(jnp.asarray(fmap), jnp.asarray(h), jnp.asarray(w),
                                           (30, 41))
    _close(tteacher.sample_teacher_features(_t(fmap), _t(h), _t(w), (30, 41)), ref)


def test_make_teacher():
    cfg = config_from_dict(GenNerfConfig, BASE).teacher
    teacher = tteacher.make_teacher(cfg)
    assert (teacher.feature_dim, teacher.patch, teacher.stride) == (C_TEACHER, 8, 4)
    np.testing.assert_array_equal(teacher.filters.numpy(),
                                  np.asarray(jteacher.make_teacher(cfg)._filters))
    assert tteacher.make_teacher(dataclasses.replace(cfg, type="none")) is None
    with pytest.raises(NotImplementedError, match="clip"):
        tteacher.make_teacher(dataclasses.replace(cfg, type="clip"))


# -- loss terms ----------------------------------------------------------------------

def _distill_inputs(rng):
    pred = rng.standard_normal((4, R, C_TEACHER)).astype(np.float32)
    pred[0, :2] = 0.0  # zero vectors: the clamp and the safe norm
    trgt = np.tanh(rng.standard_normal((4, R, C_TEACHER))).astype(np.float32)
    mask = (rng.uniform(size=(4, R, 1)) > 0.3).astype(np.float32)
    return pred, trgt, mask


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("metric", ["cosine", "l2"])
def test_loss_distill(rng, metric, masked):
    """The per-ray term and its gradient with respect to the prediction."""
    pred, trgt, mask = _distill_inputs(rng)
    cfg_d = {"use_distill": True, "distill": {"metric": metric}}
    targets = {"teacher_feat": trgt}
    if masked:
        targets["teacher_mask"] = mask

    def jf(p):
        m = jl.loss_distill(j_config_from_dict(JLossConfig, cfg_d), {"feat_sem_surface": p},
                            {k: jnp.asarray(v) for k, v in targets.items()})
        return (m * jnp.arange(1, m.size + 1).reshape(m.shape)).sum(), m

    (_, ref), ref_grad = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(pred))
    p = _t(pred).requires_grad_()
    m = tl.loss_distill(config_from_dict(LossConfig, cfg_d), {"feat_sem_surface": p},
                        {k: _t(v) for k, v in targets.items()})
    (m * torch.arange(1, m.numel() + 1, dtype=torch.float32).reshape(m.shape)).sum().backward()
    _close(m, ref, 1e-6, "loss")
    _close(p.grad, ref_grad, 1e-5, "grad")
    with pytest.raises(NotImplementedError, match="l1"):
        tl.loss_distill(config_from_dict(LossConfig, {"distill": {"metric": "l1"}}),
                        {"feat_sem_surface": p}, {"teacher_feat": _t(trgt)})


@pytest.mark.parametrize("masked", [False, True])
def test_calculate_loss_with_distill(rng, masked):
    """The combined loss (the distillation mean added outside the
    point-wise masked mean), every term, distill_coverage, and the
    gradients with respect to every output."""
    pred, trgt, mask = _distill_inputs(rng)
    S = 1 + N_STRAT + M_GAUSS
    outputs = {"tsdf": rng.uniform(-1, 1, (4, R * S, 1)).astype(np.float32),
               "feat_sem_surface": pred}
    targets = {"tsdf": rng.uniform(-1, 1, (4, R * S, 1)).astype(np.float32),
               "valid": (rng.uniform(size=(4, R * S, 1)) > 0.2).astype(np.float32),
               "teacher_feat": trgt}
    if masked:
        targets["teacher_mask"] = mask
    cfg_d = {"use_isdf": True, "use_distill": True, "distill": {"weight": 0.7}}

    def jloss(o):
        return jl.calculate_loss(j_config_from_dict(JLossConfig, cfg_d), o,
                                 {k: jnp.asarray(v) for k, v in targets.items()})

    (ref, ref_terms), ref_grads = jax.value_and_grad(jloss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in outputs.items()})
    out_t = {k: _t(v).requires_grad_() for k, v in outputs.items()}
    loss, terms = tl.calculate_loss(config_from_dict(LossConfig, cfg_d), out_t,
                                    {k: _t(v) for k, v in targets.items()})
    loss.backward()
    assert set(terms) == set(ref_terms) and ("distill_coverage" in terms) == masked
    for k in ref_terms:
        _close(terms[k], ref_terms[k], 1e-6, k)
    for k in outputs:
        _close(out_t[k].grad, ref_grads[k], 1e-5, k)


# -- surface mode ---------------------------------------------------------------------

def test_surface_step_matches_jax(batch):
    """Loss, metrics (distill, distill_coverage unscaled by T) and every
    parameter's gradient of a surface-mode train step."""
    cfg = cfg_dict("surface")
    task, params, _ = jax_params(cfg, batch)
    key = jax.random.PRNGKey(11)
    metrics_j, grads_j = jax_loss_and_grads(task, params, {}, batch, key)
    # 16 + 10 of the 32 rays have a valid pixel; the coverage is not scaled by T
    assert metrics_j["distill_coverage"] == 26 / 32 and metrics_j["distill"] > 0
    model = port_model(cfg, params)
    loss, metrics = gen_nerf_forward_loss(model, batch_to_device(batch, "cpu"),
                                          draws=step_draws(key, cfg))
    loss.backward()
    check_step(model, metrics, metrics_j, grads_j)


def test_surface_eval_step_matches_jax(batch):
    """The eval step distills too (under no_grad, the metrics only), l2."""
    cfg = cfg_dict("surface", metric="l2")
    task, params, _ = jax_params(cfg, batch)
    key = jax.random.PRNGKey(12)
    metrics_j, _ = jax_loss_and_grads(task, params, {}, batch, key, train=False)
    metrics = eval_step(port_model(cfg, params), batch_to_device(batch, "cpu"),
                        draws=step_draws(key, cfg))
    assert not any(v.requires_grad for v in metrics.values())
    check_step(None, metrics, metrics_j)


@pytest.mark.parametrize("case", ["teacher_none", "surface_under_frustum"])
def test_silent_cases_add_nothing(batch, full_batch, case):
    """As in the reference, use_distill adds no term and no metric without
    a teacher or in surface mode under frustum sampling: the metrics equal
    JAX's and those of the same step without use_distill."""
    if case == "teacher_none":
        cfg = cfg_dict("surface", teacher="none")
    else:
        cfg, batch = cfg_dict("surface", sampling="frustum"), full_batch
    task, params, _ = jax_params(cfg, batch)
    key = jax.random.PRNGKey(13)
    metrics_j, _ = jax_loss_and_grads(task, params, {}, batch, key)
    assert not any(k.startswith("distill") for k in metrics_j)
    tb = batch_to_device(batch, "cpu")
    _, metrics = gen_nerf_forward_loss(port_model(cfg, params), tb, draws=step_draws(key, cfg))
    check_step(None, metrics, metrics_j)
    off = dict(cfg, loss=dict(cfg["loss"], use_distill=False))
    _, plain = gen_nerf_forward_loss(port_model(off, params), tb, draws=step_draws(key, cfg))
    assert {k: float(v.detach()) for k, v in plain.items()} == {
        k: float(v.detach()) for k, v in metrics.items()}


# -- use_auxiliary --------------------------------------------------------------------

# the ResNet's features at feature_scale 0.5 are a quarter of the frame,
# as the teacher's at stride 4: both packages concatenate the two maps, so
# they must agree (on 24x32 frames; at 30x41 both raise)
SPATIAL = {"backbone": "resnet18", "num_layers": 2, "feature_scale": 0.5, "blur_image": False,
           "frame_chunk": 1}


@pytest.mark.parametrize("spatial", [False, True], ids=["teacher_only", "spatial_chunk_remat"])
def test_auxiliary_step_matches_jax(batch, spatial):
    """The teacher's features backprojected into the volume (after the
    spatial encoder's channels, under frame_chunk 1 and remat, on 24x32
    frames): the encoded planes, volume and counts, then a surface-mode
    train step's loss, metrics and gradients."""
    cfg = cfg_dict("surface", auxiliary=True, spatial=SPATIAL if spatial else None)
    if spatial:
        cfg["remat"] = True
        batch = training_batch(1, T, 24, 32, VOXEL_DIM, VS, seed=4)
    npix = batch["depth"].shape[2] * batch["depth"].shape[3]
    task, params, stats = jax_params(cfg, batch)
    key = jax.random.PRNGKey(14)
    origin = np.zeros(3, np.float32)
    repr_j = jax.jit(lambda p, s: task.model.apply(
        {"params": p, "batch_stats": s},
        *(jnp.asarray(batch[k]) for k in ("projection", "image", "depth")),
        key, VOXEL_DIM, jnp.asarray(origin), method=JGenNerf.encode))(params, stats)
    model = port_model(cfg, params, stats).eval()
    fps_key, k_pre = jax.random.split(key)
    with torch.no_grad():
        repr_ = model.encode(*(_t(batch[k]) for k in ("projection", "image", "depth")),
                             sel=_t(jax.random.randint(k_pre, (T, 64), 0, npix)),
                             start=_t(jax.random.randint(fps_key, (T,), 0, 64)),
                             voxel_dim=VOXEL_DIM, origin=_t(origin))
    c_spatial = spatial_latent_size("resnet18", 2) if spatial else 0
    assert repr_.volume.shape[1] == c_spatial + C_TEACHER
    for plane in repr_.planes:
        _close(repr_.planes[plane], repr_j.planes[plane], name=plane)
    _close(repr_.volume, repr_j.volume, name="volume")
    _close(repr_.valid, repr_j.valid, name="valid")
    assert float(repr_j.valid.max()) == T and float(np.abs(repr_j.volume).max()) > 0.05

    metrics_j, grads_j = jax_loss_and_grads(task, params, stats, batch, key)
    model = port_model(cfg, params, stats)
    loss, metrics = gen_nerf_forward_loss(model.train(), batch_to_device(batch, "cpu"),
                                          draws=step_draws(key, cfg, npix=npix))
    loss.backward()
    check_step(model, metrics, metrics_j, grads_j)


def test_auxiliary_needs_its_teacher():
    """use_auxiliary without a teacher, or with one of another width,
    raises ValueError (as the JAX GenNerf and GenNerfTask)."""
    cfg = config_from_dict(GenNerfConfig, cfg_dict(auxiliary=True, teacher="none"))
    with pytest.raises(ValueError, match="use_auxiliary"):
        GenNerf(cfg)
    with pytest.raises(ValueError, match="use_auxiliary"):
        TTask.build(cfg)
    wide = cfg_dict(auxiliary=True)
    wide["encoder"]["auxiliary_dim"] = C_TEACHER + 1
    with pytest.raises(ValueError, match="auxiliary_dim"):
        TTask.build(config_from_dict(GenNerfConfig, wide))
    assert config_from_dict(GenNerfConfig, cfg_dict(auxiliary=True)).encoder_latent == 8 + 8


def test_auxiliary_scene_takes_no_kernel(batch, monkeypatch):
    """A use_auxiliary pointnet model has a feature volume, so `reconstruct`
    and `render_views` reach neither the grid decode (K2) nor the point
    decode (K3): their volume and depths equal the plain decode's."""
    cfg = dict(cfg_dict(auxiliary=True), mask_unobserved=False)
    model = build_model(cfg, "cpu", seed=0)
    assert not tpred.uses_grid_decode(model)
    calls = []
    for name in ("grid_decode", "fused_resnetfc_tsdf", "fused_resnetfc_tsdf_plain"):
        real = getattr(tpred, name)
        monkeypatch.setattr(tpred, name, lambda *a, _r=real, _n=name, **k: (calls.append(_n),
                                                                            _r(*a, **k))[1])
    args = [_t(batch[k][0]) for k in ("projection", "image", "depth")]
    sel = torch.randint(0, H * W, (T, 64), generator=torch.Generator().manual_seed(0))
    start = torch.randint(0, 64, (T,), generator=torch.Generator().manual_seed(1))
    vol = reconstruct(model, *args, VOXEL_DIM, sel=sel, start=start)
    with torch.no_grad():
        repr_ = model.encode(*(a[None] for a in args), sel=sel, start=start,
                             voxel_dim=VOXEL_DIM)
        pts = tpred.dense_grid_points(VOXEL_DIM, VS, torch.zeros(3))
        plain = tpred.decode_dense(model, repr_, pts).reshape(VOXEL_DIM)
    assert repr_.volume is not None
    np.testing.assert_array_equal(vol.numpy(), plain.numpy())
    views = [render_views(model, *args, _t(batch["intrinsics"][0]), _t(batch["pose"][0]),
                          num_views=1, use_kernel_path=k, sel=sel, start=start)
             for k in (True, False)]
    np.testing.assert_array_equal(views[0]["depth"], views[1]["depth"])
    assert calls == []


# -- configs -------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["distill_synthetic", "distill_render_synthetic"])
def test_distill_configs_read_as_jax(name):
    """Both experiments load, pass check_supported and build, with the
    distillation and teacher settings the JAX package reads."""
    d = load_experiment_model_config(os.path.join(REPO, "configs", "experiment", name + ".yaml"))
    ours, ref = config_from_dict(GenNerfConfig, d), j_config_from_dict(JConfig, d)
    check_supported(ours)
    assert dataclasses.asdict(ours.loss.distill) == dataclasses.asdict(ref.loss.distill)
    assert dataclasses.asdict(ours.teacher) == dataclasses.asdict(ref.teacher)
    assert ours.loss.use_distill and ours.teacher.type == "random_projection"
    assert ours.loss.distill.mode == ("render" if "render" in name else "surface")
    assert ours.encoder_latent == ref.encoder_latent == 32
    model = build_model(d, "cpu")
    assert model.teacher.feature_dim == ours.mlp.d_out_sem == 64
