"""The port's spatial path on the CPU against the JAX package: the ResNet
stages (BasicBlock and Bottleneck, eval and train mode, the new
batch_stats), the blur and the align-corners resize, the spatial encoder,
backproject and backproject_fold, the combined and spatial-only
GenNerf.encode/decode at a non-zero origin, one train-mode forward and
backward with frame_chunk and remat (loss, every gradient, the new running
statistics), frame_chunk 0/1/3 in eval mode, remat against no remat,
`reconstruct` against GenNerfTask.reconstruct, the weight carry-over (the
flax <-> port mapping, the backbone npz of both tools, the graft, the
train CLI's npz read by the predict CLI, an old pointnet-only npz) and the
config gate.

Sizes are small (resnet18/34/50 at 16-48 px, num_layers 2-4, T <= 4, a
16x16x8 grid). JAX runs under default_matmul_precision("highest"), torch
with TF32 off. The BatchNorm parameters and statistics are randomized so
that normalization does work, and every residual block's zero-init fc_1 too.

Tolerances: features, volumes and decoded values within 1e-5 relative,
with an absolute floor of 1e-5 of the tensor's largest magnitude (float32
convolutions summed in another order); backprojected values exactly equal
on valid voxels (one gather each) and within 1e-6 overall; a train step's
loss within 1e-5 relative, every gradient within 1e-4 of its tensor's
largest magnitude (the test_torch_train bound), the new running statistics
within 1e-5 relative (flax takes E[x^2] - E[x]^2, torch a two-pass
variance); remat against no remat in one framework: running statistics
equal, loss within 1e-6 relative, gradients within 1e-5 of max-abs.
"""
import copy
import os
import shutil
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gennerf_tpu.models.gen_nerf import GenNerf as JGenNerf
from gennerf_tpu.models.gen_nerf import SceneRepr as JRepr
from gennerf_tpu.models.resnet import ResNetStages as JResNetStages
from gennerf_tpu.models.spatial_encoder import SpatialEncoder as JSpatialEncoder
from gennerf_tpu.models.spatial_encoder import _resize_bilinear_align_corners as j_resize
from gennerf_tpu.ops import projection as jproj
from gennerf_tpu.ops import value_transforms as jvt
from gennerf_tpu.train.step import gen_nerf_forward_loss as j_forward_loss
from gennerf_tpu.train.state import TrainState
from gennerf_tpu.train.tasks import GenNerfTask, _maybe_load_pretrained
from gennerf_tpu_torch.data.synthetic import training_batch
from gennerf_tpu_torch.models.config import GenNerfConfig, check_supported, config_from_dict
from gennerf_tpu_torch.models.gen_nerf import GenNerf, SceneRepr
from gennerf_tpu_torch.models.resnet import ResNetStages
from gennerf_tpu_torch.models.spatial_encoder import (
    SpatialEncoder, resize_bilinear_align_corners, spatial_latent_size,
)
from gennerf_tpu_torch.ops import projection as tproj
from gennerf_tpu_torch.ops import value_transforms as tvt
from gennerf_tpu_torch.predict import build_model, reconstruct
from gennerf_tpu_torch.predict import main as predict_main
from gennerf_tpu_torch.tools import port_backbone
from gennerf_tpu_torch.train import predict as tpred
from gennerf_tpu_torch.train.__main__ import main as train_main
from gennerf_tpu_torch.train.step import StepDraws, batch_to_device, eval_step, train_step
from gennerf_tpu_torch.train.step import gen_nerf_forward_loss
from gennerf_tpu_torch.train.state import make_optimizer
from gennerf_tpu_torch.utils.config import load_experiment_model_config
from gennerf_tpu_torch.utils.port_params import (
    flax_params_from_gen_nerf, flax_variables_from_gen_nerf, gen_nerf_npz_tree,
    gen_nerf_params_from_flax, load_params_npz, resnet_state_from_flax, save_params_npz,
)

import _torch_threads  # noqa: F401  (sizes torch's threads per xdist worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOXEL_DIM = (16, 16, 8)
VS = 0.08
T, H, W = 3, 24, 32
R, N_STRAT, M_GAUSS = 16, 5, 3
ORIGIN = np.array([0.04, -0.08, 0.02], np.float32)
POINTNET = {"num_sparse_points": 32, "fps_presample": 64, "normalize_coords": True, "c_dim": 8,
            "hidden_dim": 8, "plane_resolution": 16, "n_blocks": 2, "unet": True,
            "unet_kwargs": {"depth": 2, "merge_mode": "concat", "start_filts": 8}}
# the spatial config of the JAX package's own frame_chunk test
# (tests/test_harness_extra.py), and the drive's shape at a small size
SPATIAL_ONLY = {"backbone": "resnet18", "num_layers": 2, "feature_scale": 1.0,
                "blur_image": False}
COMBINED = {"backbone": "resnet18", "num_layers": 3, "feature_scale": 2.0, "blur_image": False}


def _cfg(spatial: dict, pointnet: bool = True, remat: bool = False, **spatial_over) -> dict:
    return {
        "type": "GenNerf", "voxel_size": VS, "voxel_dim_train": list(VOXEL_DIM),
        "voxel_dim_val": list(VOXEL_DIM), "voxel_dim_test": list(VOXEL_DIM), "remat": remat,
        "encoder": {"use_spatial": True, "spatial": {**spatial, **spatial_over},
                    "use_pointnet": pointnet, "pointnet": POINTNET},
        "mlp": {"d_out_sem": 1, "d_out_geo": 8, "n_blocks": 2, "d_hidden": 32, "alpha": 0.7},
        "code": {"num_freqs": 6, "freq_factor": 0.5, "include_input": True},
        "ray": {"num_rays": R, "N": N_STRAT, "M": M_GAUSS},
        "loss": {"use_tsdf": True, "tsdf": {"weight": 1.0, "transform": "smooth_log",
                                            "shift": 15.0, "smoothness": 10.0}},
        "optimizer": {"type": "Adam", "lr": 0.001, "weight_decay": 0.0001},
    }


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(ours, ref, rtol=1e-5):
    ref = np.asarray(ref)
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=rtol,
                               atol=rtol * max(float(np.abs(ref).max()), 1e-30))


@pytest.fixture(autouse=True)
def _f32_highest():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with jax.default_matmul_precision("highest"):
        yield


def _randomize(params: dict, stats: dict, seed: int):
    """numpy copies of flax variables with BatchNorm scales, biases and
    statistics and every zero-init Dense_1 drawn at random."""
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda a: np.array(a, np.float32), params)
    stats = jax.tree.map(lambda a: np.array(a, np.float32), stats)

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
    return params, stats


def _batch(seed=3, frames=T):
    return training_batch(1, frames, H, W, VOXEL_DIM, VS, seed=seed)


def _pair(cfg_dict, batch, seed=5):
    """(GenNerfTask, randomized params, stats, port model with the same weights)."""
    task = GenNerfTask(cfg_dict)
    variables = jax.jit(task.model.init, static_argnums=(6,))(
        jax.random.PRNGKey(0), *(jnp.asarray(batch[k]) for k in ("projection", "image", "depth")),
        jnp.zeros((1, 8, 3)), jax.random.PRNGKey(0), VOXEL_DIM, jnp.zeros(3))
    params, stats = _randomize(dict(variables["params"]), dict(variables["batch_stats"]), seed)
    model = GenNerf(config_from_dict(GenNerfConfig, cfg_dict))
    model.load_state_dict(gen_nerf_params_from_flax(params, stats))
    return task, params, stats, model


def _torch_model(cfg_dict, seed=5) -> GenNerf:
    """A port model from a seeded init with its BatchNorm parameters and
    statistics and its zero-init fc_1 layers drawn at random (the
    framework-internal tests need no JAX weights)."""
    torch.manual_seed(seed)
    model = GenNerf(config_from_dict(GenNerfConfig, cfg_dict))
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("running_var") or (".bn" in name or "downsample.1" in name) and \
                    name.endswith("weight"):
                t.copy_(0.5 + torch.rand(t.shape, generator=g) * (1.5 if "running" in name else 1))
            elif name.endswith("running_mean") or (".bn" in name or "downsample.1" in name) and \
                    name.endswith("bias") or ".fc_1." in name:
                t.copy_(0.1 * torch.randn(t.shape, generator=g))
    return model


def _encode_draws(key, BT, npix, presample=64):
    key_fps, k_pre = jax.random.split(key)
    return (_t(jax.random.randint(k_pre, (BT, presample), 0, npix)),
            _t(jax.random.randint(key_fps, (BT,), 0, presample)))


def _stats_state(model) -> dict:
    return {k: v.clone() for k, v in model.state_dict().items() if k.endswith(("running_mean",
                                                                               "running_var"))}


# -- ResNet, blur, resize, encoder --------------------------------------------

@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("backbone,num_stages", [("resnet18", 3), ("resnet34", 3),
                                                 ("resnet50", 2)])
def test_resnet_stages(rng, backbone, num_stages, train):
    """Every stage's features and, in training mode, the new batch_stats
    (the biased variance: layer3's maps are 2x2, where n/(n-1) is 8/7).
    Training mode divides by batch standard deviations over 8-32 values a
    channel, which carries float32 rounding through: there the port is held
    within 1e-5 of max-abs of its own float64 evaluation, and the JAX
    features (themselves up to 1.2e-5 of max-abs off that float64
    evaluation) within 3e-5 of the port's."""
    x = rng.standard_normal((2, 3, 32, 32)).astype(np.float32)
    jm = JResNetStages(backbone=backbone, num_stages=num_stages)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    params, stats = _randomize(v["params"], v["batch_stats"], 1)
    ref, mut = jax.jit(lambda v_, x_: jm.apply(v_, x_, train=train, mutable=["batch_stats"]))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x.transpose(0, 2, 3, 1)))
    ours_m = ResNetStages(backbone, num_stages)
    ours_m.load_state_dict(_t_state(resnet_state_from_flax(params, stats)))
    f64 = copy.deepcopy(ours_m).double().train(train)
    ours_m.train(train)
    ours = ours_m(_t(x))
    exact = f64(_t(x).double())
    assert len(ours) == len(ref) == num_stages + 1
    for o, r, e in zip(ours, ref, exact):
        _close(o, np.asarray(r).transpose(0, 3, 1, 2), rtol=3e-5 if train else 1e-5)
        _close(o, e.detach().numpy())
    new = resnet_state_from_flax(params, mut["batch_stats"])
    for k, v in ours_m.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            _close(v, new[k])
            assert train or np.array_equal(v.numpy(), new[k])


def _t_state(d):
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in d.items()}


def test_gaussian_blur(rng):
    img = rng.uniform(0, 1, (2, 3, 20, 28)).astype(np.float32)
    for k, sigma in ((41, 10.0), (5, 1.0)):
        np.testing.assert_allclose(tvt.gaussian_kernel_1d(k, sigma).numpy(),
                                   np.asarray(jvt.gaussian_kernel_1d(k, sigma)), rtol=1e-6)
        _close(tvt.apply_gaussian_smoothing(_t(img), k, sigma),
               jvt.apply_gaussian_smoothing(jnp.asarray(img), k, sigma))


@pytest.mark.parametrize("hw,out", [((5, 7), (17, 13)), ((60, 80), (480, 640)),
                                    ((24, 32), (48, 64)), ((3, 4), (3, 4))])
def test_resize_align_corners_matches_bitwise(rng, hw, out):
    """The reference's linspace rounding, term for term: equal bits."""
    x = rng.standard_normal((1, 2, *hw)).astype(np.float32)
    ref = np.asarray(j_resize(jnp.asarray(x.transpose(0, 2, 3, 1)), out)).transpose(0, 3, 1, 2)
    np.testing.assert_array_equal(resize_bilinear_align_corners(_t(x), out).numpy(), ref)


@pytest.mark.parametrize("kw", [
    {"feature_scale": 2.0, "blur_image": False, "out_channels": None},
    {"feature_scale": 1.0, "blur_image": True, "kernel_size": 9, "sigma": 2.0,
     "out_channels": None},
    {"feature_scale": 0.5, "blur_image": False, "out_channels": 24},
    {"feature_scale": 2.0, "blur_image": True, "kernel_size": 41, "sigma": 10.0,
     "out_channels": 16},
])
def test_spatial_encoder(rng, kw):
    x = rng.uniform(0, 1, (2, 3, 24, 32)).astype(np.float32)
    jm = JSpatialEncoder(backbone="resnet18", num_layers=3, **kw)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 3, 24, 32)))
    params, stats = _randomize(v["params"], v["batch_stats"], 2)
    ref = jax.jit(jm.apply)({"params": params, "batch_stats": stats}, jnp.asarray(x))
    model = SpatialEncoder("resnet18", 3, **kw).eval()
    state = resnet_state_from_flax(params["resnet"], stats["resnet"], "resnet.")
    if kw["out_channels"]:
        state["proj.weight"] = params["proj"]["kernel"].transpose(3, 2, 0, 1)
        state["proj.bias"] = params["proj"]["bias"]
    model.load_state_dict(_t_state(state))
    ours = model(_t(x))
    assert ours.shape[1] == model.latent_size == (kw["out_channels"] or 64 + 64 + 128)
    _close(ours, ref)


def test_spatial_latent_size():
    assert spatial_latent_size("resnet34", 4) == 512
    assert spatial_latent_size("resnet50", 4) == 1856
    cfg = config_from_dict(GenNerfConfig, load_experiment_model_config(
        os.path.join(REPO, "configs", "experiment", "seqs_multigeo_spatial.yaml")))
    assert cfg.encoder_latent == 544


# -- backprojection --------------------------------------------------------------

def test_backproject_and_fold(rng):
    batch = _batch(frames=4)
    P = batch["projection"]  # (1, 4, 3, 4) at 24x32 pixels
    feat = rng.standard_normal((4, 5, 12, 16)).astype(np.float32)  # half-resolution features
    vol_j, val_j = jproj.backproject(VOXEL_DIM, VS, jnp.asarray(ORIGIN), jnp.asarray(P[0, :2]),
                                     jnp.asarray(feat[:2]))
    vol_t, val_t = tproj.backproject(VOXEL_DIM, VS, _t(ORIGIN), _t(P[0, :2]), _t(feat[:2]))
    np.testing.assert_array_equal(val_t.numpy(), np.asarray(val_j))
    assert 0 < val_t.mean() < 1
    np.testing.assert_array_equal(vol_t.numpy(), np.asarray(vol_j))
    far = ORIGIN - 0.5  # moves part of the grid out of the frames' frusta
    fold_j = jproj.backproject_fold(jnp.asarray(feat), jnp.asarray(P), (H, W), VOXEL_DIM, VS,
                                    jnp.asarray(far))
    fold_t = tproj.backproject_fold(_t(feat), _t(P), (H, W), VOXEL_DIM, VS, _t(far))
    np.testing.assert_array_equal(fold_t[1].numpy(), np.asarray(fold_j[1]))
    counts = np.asarray(fold_j[1])
    assert (counts > 0).any() and (counts < 4).any(), "the grid must leave some frusta"
    np.testing.assert_allclose(fold_t[0].numpy(), np.asarray(fold_j[0]), rtol=0, atol=1e-6)
    unseen = np.broadcast_to(counts == 0, fold_t[0].shape)
    assert (fold_t[0].numpy()[unseen] == 0).all()


# -- GenNerf encode / decode ---------------------------------------------------

@pytest.mark.parametrize("spatial,pointnet", [(COMBINED, True), (SPATIAL_ONLY, False)])
def test_gen_nerf_encode_decode(rng, spatial, pointnet):
    """Eval-mode encode at a non-zero origin (the JAX draws injected), then
    decode of the JAX scene at points in and around the volume."""
    cfg = _cfg(spatial, pointnet)
    batch = _batch()
    task, params, stats, model = _pair(cfg, batch)
    model.eval()
    key = jax.random.PRNGKey(3)
    sel, start = _encode_draws(key, T, H * W)
    encode = jax.jit(lambda v, *a: task.model.apply(v, *a, VOXEL_DIM, jnp.asarray(ORIGIN),
                                                    train=False, method=JGenNerf.encode))
    ref = encode({"params": params, "batch_stats": stats},
                 *(jnp.asarray(batch[k]) for k in ("projection", "image", "depth")), key)
    with torch.no_grad():
        ours = model.encode(*(_t(batch[k]) for k in ("projection", "image", "depth")),
                            sel=sel, start=start, voxel_dim=VOXEL_DIM, origin=_t(ORIGIN))
    np.testing.assert_array_equal(ours.valid.numpy(), np.asarray(ref.valid))
    _close(ours.volume, ref.volume)
    assert (ours.planes is None) == (not pointnet)
    for k in ("xz", "xy", "yz") if pointnet else ():
        _close(ours.planes[k], ref.planes[k])
    xyz = rng.uniform(-0.2, 1.4, (1, 60, 3)).astype(np.float32)
    dec_ref = jax.jit(lambda v, r, p: task.model.apply(v, r, p, jnp.asarray(ORIGIN),
                                                       method=JGenNerf.decode))(
        {"params": params, "batch_stats": stats}, ref, jnp.asarray(xyz))
    repr_j = SceneRepr(None if ref.planes is None else {k: _t(v) for k, v in ref.planes.items()},
                       _t(ref.volume), _t(ref.valid))
    with torch.no_grad():
        dec = model.decode(repr_j, _t(xyz), _t(ORIGIN))
    for k in ("feat", "feat_geo", "feat_sem", "tsdf"):
        _close(dec[k], dec_ref[k])
    assert dec["feat"].shape[-1] == model.cfg.encoder_latent


def test_merge_sums_volume_and_valid(rng):
    model = GenNerf(config_from_dict(GenNerfConfig, _cfg(SPATIAL_ONLY, pointnet=False)))
    a, b = (SceneRepr(None, _t(rng.standard_normal((1, 4, 2, 2, 2)).astype(np.float32)),
                      _t(rng.integers(0, 3, (1, 1, 2, 2, 2)).astype(np.float32))) for _ in range(2))
    merged = model.merge(a, b)
    assert merged.planes is None
    torch.testing.assert_close(merged.volume, a.volume + b.volume)
    torch.testing.assert_close(merged.valid, a.valid + b.valid)


# -- a train-mode step ----------------------------------------------------------

def _step_draws(key, BT, presample=64, npix=H * W):
    k_enc, k_sample = jax.random.split(key)
    fps_key, k_pre = jax.random.split(k_enc)
    k_pix, k_pts = jax.random.split(k_sample)
    return StepDraws(
        sel=_t(jax.random.randint(k_pre, (BT, presample), 0, npix)),
        start=_t(jax.random.randint(fps_key, (BT,), 0, presample)),
        scores=_t(jax.random.uniform(k_pix, (BT, npix))),
        noise=_t(jax.random.normal(k_pts, (BT, R, M_GAUSS))))


@pytest.mark.parametrize("spatial,pointnet", [(SPATIAL_ONLY, False),
                                              (dict(COMBINED, out_channels=16), True)])
def test_train_step_matches_jax(spatial, pointnet):
    """frame_chunk 1 with remat, training mode: the loss, every gradient and
    the running statistics after the step, against jax.value_and_grad of
    the JAX forward loss with mutable batch_stats. The combined case
    projects the concat to 16 channels (`proj`): this small decoder's tanh
    head saturates on the 256-channel concat, which leaves every gradient
    near 1e-8, at float32 noise."""
    cfg = _cfg(spatial, pointnet, remat=True, frame_chunk=1)
    batch = _batch()
    task, params, stats, model = _pair(cfg, batch)
    key = jax.random.PRNGKey(11)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items() if isinstance(v, np.ndarray)}

    def loss_fn(p):
        loss, metrics, new_stats = j_forward_loss(task.model, task.cfg, p, stats, jbatch, key,
                                                  VOXEL_DIM, train=True)
        return loss, (metrics, new_stats)

    (ref_loss, (ref_metrics, ref_stats)), ref_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    model.train()
    loss, metrics = gen_nerf_forward_loss(model, batch_to_device(batch, "cpu"),
                                          draws=_step_draws(key, T))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=1e-5)
    assert set(metrics) == set(ref_metrics)
    for k, v in ref_metrics.items():
        np.testing.assert_allclose(float(metrics[k].detach()), float(v), rtol=1e-5, atol=1e-7)
    grads = gen_nerf_params_from_flax(jax.tree.map(np.asarray, ref_grads))
    named = dict(model.named_parameters())
    assert set(named) <= set(grads)
    for name, p in named.items():
        ref_g = grads[name].numpy()
        scale = max(float(np.abs(ref_g).max()), 1e-12)
        np.testing.assert_allclose(p.grad.numpy(), ref_g, rtol=0, atol=1e-4 * scale, err_msg=name)
    new = gen_nerf_params_from_flax(params, jax.tree.map(np.asarray, ref_stats))
    old = gen_nerf_params_from_flax(params, stats)
    for k, v in _stats_state(model).items():
        _close(v, new[k].numpy())
        assert not torch.equal(v, old[k]), k


@pytest.mark.parametrize("chunk", [1, 3])
def test_frame_chunk_matches_one_pass_in_eval_mode(chunk):
    """Chunked encode equals the one-pass encode in eval mode (BatchNorm on
    its running statistics; train mode normalizes each chunk by its own
    batch, as the reference's per-frame loop does), T = 4 (3: ragged)."""
    batch = _batch(frames=4)
    one_pass = _torch_model(_cfg(COMBINED))
    chunked = GenNerf(config_from_dict(GenNerfConfig, _cfg(COMBINED, frame_chunk=chunk)))
    chunked.load_state_dict(one_pass.state_dict())
    b = batch_to_device(batch, "cpu")
    draws = _step_draws(jax.random.PRNGKey(4), 4)
    with torch.no_grad():
        outs = [m.eval().encode(b["projection"], b["image"], b["depth"], sel=draws.sel,
                                start=draws.start, voxel_dim=VOXEL_DIM, origin=_t(ORIGIN))
                for m in (one_pass, chunked)]
    _close(outs[1].volume, outs[0].volume.numpy())
    torch.testing.assert_close(outs[1].valid, outs[0].valid, rtol=0, atol=0)
    for k in outs[0].planes:
        torch.testing.assert_close(outs[1].planes[k], outs[0].planes[k], rtol=0, atol=0)
    m0, m1 = (eval_step(m, b, draws=draws) for m in (one_pass, chunked))
    np.testing.assert_allclose(float(m1["combined"]), float(m0["combined"]), rtol=1e-5)


@pytest.mark.parametrize("chunk", [0, 1])
def test_remat_leaves_the_running_statistics_of_a_plain_step(chunk):
    """A remat step (checkpointed encoder or chunks, recomputed in
    backward) moves the running statistics once: equal to the step without
    remat; its loss and gradients agree too."""
    batch = _batch()
    plain = _torch_model(_cfg(COMBINED, frame_chunk=chunk))
    remat = GenNerf(config_from_dict(GenNerfConfig, _cfg(COMBINED, remat=True, frame_chunk=chunk)))
    remat.load_state_dict(plain.state_dict())
    before = _stats_state(plain)
    draws = _step_draws(jax.random.PRNGKey(6), T)
    results = []
    for m in (plain, remat):
        opt = make_optimizer(m.parameters(), m.cfg.optimizer, None)
        metrics = train_step(m, opt, batch_to_device(batch, "cpu"), draws=draws)
        results.append((float(metrics["combined"]), {n: p.grad.clone() for n, p in
                                                       m.named_parameters()}))
    after_plain, after_remat = _stats_state(plain), _stats_state(remat)
    for k in before:
        assert not torch.equal(after_plain[k], before[k]), k
        torch.testing.assert_close(after_remat[k], after_plain[k], rtol=0, atol=0)
    np.testing.assert_allclose(results[1][0], results[0][0], rtol=1e-6)
    for n, g in results[0][1].items():
        scale = max(float(g.abs().max()), 1e-12)
        torch.testing.assert_close(results[1][1][n], g, rtol=0, atol=1e-5 * scale)


# -- predict --------------------------------------------------------------------

def test_reconstruct_matches_jax():
    """The spatial scene's dense f32 decode (K2's gate excludes volume
    scenes) with the fusion prior, against GenNerfTask.reconstruct; its
    volume is encoded on the decode grid."""
    cfg = _cfg(COMBINED)
    batch = _batch(seed=7)
    task, params, stats, model = _pair(cfg, batch)
    gt = {k: v for k, v in batch.items() if not k.startswith("vol_")}
    pred, trgt = task.reconstruct(TrainState(0, params, stats, None), gt)
    assert trgt is None
    assert not tpred.uses_grid_decode(model)
    sel, start = _encode_draws(jax.random.PRNGKey(0), T, H * W)
    ours = reconstruct(model.eval(), batch["projection"][0], batch["image"][0],
                       batch["depth"][0], sel=sel, start=start)
    assert tuple(ours.shape) == VOXEL_DIM and ours.dtype == torch.float32
    _close(ours, pred.tsdf_vol)
    ref = np.asarray(pred.tsdf_vol)
    assert ((np.abs(ref) < 1) & (ref != 1)).any()
    with pytest.raises(NotImplementedError, match="triplane-only"):
        repr_ = model.encode(*(_t(batch[k][0])[None] for k in ("projection", "image", "depth")),
                             voxel_dim=VOXEL_DIM)
        tpred.make_point_tsdf_fn(model, repr_)


def test_render_marches_a_spatial_scene_in_f32():
    """render_views takes the f32 decode for a spatial config (the kernel
    path is chosen from the config, before the march): the same views as
    asking for the f32 march."""
    from gennerf_tpu_torch.render import render_views

    model = _torch_model(_cfg(COMBINED)).eval()
    b = _batch(seed=7)
    args = [b[k][0] for k in ("projection", "image", "depth", "intrinsics", "pose")]
    sel, start = _encode_draws(jax.random.PRNGKey(0), T, H * W)
    views = [render_views(model, *args, num_views=2, use_kernel_path=k, sel=sel, start=start)
             for k in (True, False)]
    assert (views[0]["ray_depth"] > 0).any()
    np.testing.assert_array_equal(views[0]["ray_depth"], views[1]["ray_depth"])


# -- weights ----------------------------------------------------------------------

def test_flax_port_flax_roundtrip_with_batch_stats():
    """Random arrays in the JAX model's tree (its shapes from eval_shape),
    to the port's state_dict and back: the same tree, the same bits."""
    cfg = _cfg(COMBINED, out_channels=12)
    batch = _batch()
    task = GenNerfTask(cfg)
    shapes = jax.eval_shape(
        lambda *a: task.model.init(*a[:6], VOXEL_DIM, a[6]), jax.random.PRNGKey(0),
        *(jnp.asarray(batch[k]) for k in ("projection", "image", "depth")),
        jnp.zeros((1, 8, 3)), jax.random.PRNGKey(0), jnp.zeros(3))
    rng = np.random.default_rng(8)
    params, stats = (jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32),
                                  dict(shapes[col])) for col in ("params", "batch_stats"))
    model = GenNerf(config_from_dict(GenNerfConfig, cfg))
    model.load_state_dict(gen_nerf_params_from_flax(params, stats))
    p2, s2 = flax_variables_from_gen_nerf(model.state_dict())
    flat = lambda t: {"/".join(str(k.key) for k in path): np.asarray(v)  # noqa: E731
                      for path, v in jax.tree_util.tree_leaves_with_path(t)}
    for a, b in ((p2, params), (s2, stats)):
        fa, fb = flat(a), flat(b)
        assert set(fa) == set(fb)
        for k in fb:
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def test_backbone_npz_equals_jax_tool(tmp_path):
    """The port's tool and scripts/port_weights.py write the same
    random:resnet34 npz key by key; torchvision-layout .pth input too."""
    import sys
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import port_weights
    finally:
        sys.path.remove(os.path.join(REPO, "scripts"))
    ref_path, ours_path = str(tmp_path / "ref.npz"), str(tmp_path / "ours.npz")
    port_weights.main(["backbone", "random:resnet34", ref_path])
    port_backbone.main(["random:resnet34", ours_path])
    with np.load(ref_path) as ref, np.load(ours_path) as ours:
        assert set(ref.files) == set(ours.files)
        for k in ref.files:
            np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    sd = port_backbone.fabricate_resnet_state_dict("resnet18", seed=3)
    torch.save({"state_dict": {"encoder.model." + k: torch.from_numpy(v) for k, v in sd.items()}},
               tmp_path / "bb.pth")
    port_weights.main(["backbone", str(tmp_path / "bb.pth"), ref_path, "--backbone", "resnet18",
                       "--num-stages", "2"])
    port_backbone.main([str(tmp_path / "bb.pth"), ours_path, "--backbone", "resnet18",
                        "--num-stages", "2"])
    with np.load(ref_path) as ref, np.load(ours_path) as ours:
        assert set(ref.files) == set(ours.files)
        for k in ref.files:
            np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


def test_build_model_grafts_the_backbone(tmp_path, rng):
    """The graft of build_model against the JAX task's init graft
    (apply_pretrained_npz): the same ResNet parameters and statistics; a torchvision state
    dict (with num_batches_tracked) loads into the ResNet directly; a
    mismatched npz raises."""
    path = str(tmp_path / "bb.npz")
    port_backbone.main(["random:resnet18", path, "--num-stages", "2"])
    cfg = _cfg(COMBINED)
    cfg["encoder"]["spatial"]["pretrained_path"] = path
    batch = _batch()
    task = GenNerfTask(cfg)
    variables = jax.jit(task.model.init, static_argnums=(6,))(
        jax.random.PRNGKey(0), *(jnp.asarray(batch[k]) for k in ("projection", "image", "depth")),
        jnp.zeros((1, 8, 3)), jax.random.PRNGKey(0), VOXEL_DIM, jnp.zeros(3))
    variables = _maybe_load_pretrained(variables, task.cfg)  # the task's init graft
    model = build_model(cfg, "cpu", seed=1)
    got = flax_variables_from_gen_nerf(model.state_dict())
    for col, tree in (("params", variables["params"]), ("batch_stats", variables["batch_stats"])):
        ours = got[0 if col == "params" else 1]["spatial"]["resnet"]
        leaves = jax.tree_util.tree_leaves_with_path(tree["spatial"]["resnet"])
        for path_, v in leaves:
            node = ours
            for k in path_:
                node = node[k.key]
            np.testing.assert_array_equal(node, np.asarray(v))
    sd = {k: torch.from_numpy(v) for k, v in
          port_backbone.fabricate_resnet_state_dict("resnet18", seed=2).items()
          if k.startswith(("conv1", "bn1", "layer1", "layer2"))}
    sd.update({k.replace("running_mean", "num_batches_tracked"): torch.tensor(5)
               for k in sd if k.endswith("running_mean")})
    model.spatial.resnet.load_state_dict(sd)
    bad = str(tmp_path / "bad.npz")
    port_backbone.main(["random:resnet34", bad])
    with pytest.raises((KeyError, ValueError)):
        port_backbone.graft_backbone(model, bad)


TINY_SPATIAL_EXPERIMENT = (
    "defaults:\n  - overfit_synthetic\n"
    "model:\n  remat: true\n  encoder:\n    use_spatial: true\n"
    "    spatial: {backbone: resnet18, num_layers: 3, feature_scale: 1.0, blur_image: false,\n"
    "              frame_chunk: 1}\n"
    "    pointnet:\n      num_sparse_points: 32\n      fps_presample: 64\n"
    "      c_dim: 8\n      hidden_dim: 8\n      plane_resolution: 16\n      n_blocks: 2\n"
    "      unet_kwargs: {depth: 2, merge_mode: concat, start_filts: 8}\n"
    "  mlp: {d_out_geo: 8, d_out_sem: 1, n_blocks: 2, d_hidden: 32}\n"
    "  ray: {num_rays: 8, N: 4, M: 2}\n"
    "trainer: {log_every_n_steps: 1, check_val_every_n_epoch: 1}\n"
    "data:\n  voxel_size: 0.08\n  voxel_dim_train: [16, 16, 8]\n  voxel_dim_val: [16, 16, 8]\n"
    "  voxel_dim_test: [16, 16, 8]\n  num_frames_train: 2\n  num_frames_val: 2\n")


def test_train_cli_npz_with_running_stats_then_predict_cli(tmp_path):
    """The train CLI trains a spatial config with a grafted backbone (a
    config override) and writes params.npz with batch_stats/; the predict
    CLI reads it back and gives the volume of the in-memory eval model; a
    resume restores the running statistics exactly."""
    shutil.copytree(os.path.join(REPO, "configs"), tmp_path / "configs")
    exp = tmp_path / "configs" / "experiment" / "tiny_spatial.yaml"
    exp.write_text(TINY_SPATIAL_EXPERIMENT)
    bb = str(tmp_path / "bb.npz")
    port_backbone.main(["random:resnet18", bb, "--num-stages", "2"])
    out = tmp_path / "run"
    trainer = train_main(["--config", str(exp), "--out", str(out), "--epochs", "2",
                          "--synthetic", "--device", "cpu",
                          f"model.encoder.spatial.pretrained_path={bb}"])
    assert trainer.global_step == 2 and trainer.model.cfg.encoder.spatial.pretrained_path == bb
    tree = load_params_npz(str(out / "params.npz"))
    assert "batch_stats" in tree and "spatial" in tree["batch_stats"]
    stats = _stats_state(trainer.model)
    assert any(not torch.equal(v, torch.zeros_like(v)) for k, v in stats.items()
               if k.endswith("running_mean"))
    frames = training_batch(1, 2, 24, 32, VOXEL_DIM, VS, seed=9)
    np.savez(tmp_path / "frames.npz", **{k: frames[k][0] for k in ("projection", "image", "depth")})
    predict_main(["--config", str(exp), "--params", str(out / "params.npz"),
                  "--frames", str(tmp_path / "frames.npz"), "--out", str(tmp_path / "tsdf.npz"),
                  "--device", "cpu"])
    with np.load(tmp_path / "tsdf.npz") as f:
        vol = f["tsdf"]
    expect = reconstruct(trainer.model.eval(), frames["projection"][0], frames["image"][0],
                         frames["depth"][0], generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(vol, expect.numpy())
    resumed = train_main(["--config", str(exp), "--out", str(tmp_path / "run2"), "--epochs", "2",
                          "--synthetic", "--device", "cpu", "--resume",
                          str(out / "checkpoints" / "epoch_0000.pt")])
    assert resumed.global_step == 2
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k


def test_pointnet_only_npz_still_loads(tmp_path):
    """A params npz in the layout before the spatial path (no spatial
    subtree, no batch_stats) loads into a pointnet-only model unchanged."""
    cfg = _cfg(COMBINED)
    cfg["encoder"]["use_spatial"] = False
    model = GenNerf(config_from_dict(GenNerfConfig, cfg))
    tree = flax_params_from_gen_nerf(model.state_dict())
    assert set(tree) == {"pointnet", "mlp", "head_geo"} and gen_nerf_npz_tree(
        model.state_dict()).keys() == tree.keys()
    save_params_npz(str(tmp_path / "p.npz"), tree)
    again = GenNerf(config_from_dict(GenNerfConfig, cfg))
    again.load_state_dict(gen_nerf_params_from_flax(load_params_npz(str(tmp_path / "p.npz"))))
    for k, v in model.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k


# -- config gate ------------------------------------------------------------------

def test_check_supported_spatial_configs():
    exp = os.path.join(REPO, "configs", "experiment")
    for name in ("seqs_multigeo_spatial", "seq1_frames8_evenspaced_spatial",
                 "seq1_frames8_evenspaced_spatialnoblur",
                 "seq1_frames8_evenspaced_pointnetspatial",
                 "seq1_frames8_evenspaced_pointnetspatialnoblur512"):
        cfg = config_from_dict(GenNerfConfig,
                               load_experiment_model_config(os.path.join(exp, name + ".yaml")))
        check_supported(cfg)
        assert cfg.encoder.use_spatial
    drive = config_from_dict(GenNerfConfig, load_experiment_model_config(
        os.path.join(exp, "seqs_multigeo_spatial.yaml")))
    s = drive.encoder.spatial
    assert (s.backbone, s.num_layers, s.feature_scale, s.blur_image, s.frame_chunk, drive.remat,
            drive.voxel_dim_train) == ("resnet34", 4, 2.0, False, 1, True, (80, 80, 40))
    base = _cfg(COMBINED)
    # norm_type is ported (tests/test_torch_spatial_options.py): sync_batch
    # is batch on one card and builds without a word
    sync = copy.deepcopy(base)
    sync["encoder"]["spatial"].update(norm_type="sync_batch")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        GenNerf(config_from_dict(GenNerfConfig, sync))
    # use_auxiliary is ported (tests/test_torch_distill.py); without a
    # teacher it raises ValueError, as the JAX GenNerf does
    for over, match, error in (
            (lambda c: c["encoder"].update(use_auxiliary=True), "use_auxiliary", ValueError),
            (lambda c: c["encoder"].update(use_pointnet=False, use_spatial=False), "neither",
             NotImplementedError)):
        cfg = copy.deepcopy(base)
        over(cfg)
        with pytest.raises(error, match=match):
            GenNerf(config_from_dict(GenNerfConfig, cfg))
    with pytest.raises(NotImplementedError, match="float32"):
        GenNerf(config_from_dict(GenNerfConfig, base), dtype=torch.float16)
    with pytest.raises(ValueError, match="voxel_dim"):
        GenNerf(config_from_dict(GenNerfConfig, base)).encode(
            torch.zeros(1, 1, 3, 4), torch.zeros(1, 1, 3, 8, 8), torch.zeros(1, 1, 8, 8))
