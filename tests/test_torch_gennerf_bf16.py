"""GenNerf under bf16-mixed on the CPU against the JAX package: ResnetFC,
the UNet, LocalPoolPointnet and the GenNerf encode + decode (pointnet-only,
and spatial + pointnet) against JAX's bf16 modules run op by op
(`jax.disable_jit()`), one train step's loss, metrics and gradients against
`jax.value_and_grad` of the JAX `gen_nerf_forward_loss` in bf16,
`decode_dense` and `reconstruct` of a bf16 model (float32 out), the dtypes
at the modules' boundaries against flax's, a bf16 step leaving the state
float32, the precision rule of `Trainer`, the flagship configuration and
its two children building and stepping in bf16, and the train -> predict
-> render CLIs of a bf16 GenNerf config.

Sizes are small (c_dim 16, 32x32 planes, UNet depth 2 with 16 filters, H 32,
2 blocks; 2 frames of 12x16; a 16x16x8 grid). The JAX draws are injected
(`StepDraws`, `encode(sel=, start=)`). JAX runs under
default_matmul_precision("highest"), torch with TF32 off.

Bounds. The distance of a result is JAX's bf16 result against JAX's float32
result. The port's bf16 result's mean absolute difference to JAX's bf16
result must be at most a quarter of the mean distance in eval mode, and
half of it for a train step's loss, metrics and gradients; its largest
difference at most the largest distance (floors: 1e-7 of the largest
magnitude for the metrics, 1e-6 for the gradients). Both frameworks round
every bf16 product once after a float32 accumulation and add the bias in
bf16, and the port casts where flax casts, so most values agree bit for
bit (the pointnet-only encode and decode here entirely); a difference in
float32 summation order (a convolution's, a norm's) flips a bf16 rounding
now and then, and one flip of an output is a bf16 ulp: 0.0039 at 0.9 in
the UNet case, above a quarter of JAX's own largest distance there
(0.0067), so the largest difference is held to the distance itself. The
spatial encode differs most: its volume 0.19 of the mean distance (the
ResNet's bf16 convolutions). The eval-mode references run op by op
(`jax.disable_jit()`); the train step's bf16 reference is compiled, which
keeps the comparison inside the half bound (0.22 of the mean distance at
most, op by op 0.15) at a fifth of the time.
"""
import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gennerf_tpu.models.gen_nerf import GenNerf as JGenNerf
from gennerf_tpu.models.pointnet import LocalPoolPointnet as JPointnet
from gennerf_tpu.models.resnetfc import ResnetFC as JResnetFC
from gennerf_tpu.models.unet import UNet as JUNet
from gennerf_tpu.train.predict import decode_dense as j_decode_dense
from gennerf_tpu.train.step import gen_nerf_forward_loss as j_forward_loss
from gennerf_tpu.train.tasks import GenNerfTask
from gennerf_tpu_torch.data.synthetic import training_batch
from gennerf_tpu_torch.models.config import GenNerfConfig, config_from_dict
from gennerf_tpu_torch.models.gen_nerf import GenNerf, SceneRepr
from gennerf_tpu_torch.predict import main as predict_main
from gennerf_tpu_torch.predict import reconstruct
from gennerf_tpu_torch.render import main as render_main
from gennerf_tpu_torch.train import predict as tpred
from gennerf_tpu_torch.train.__main__ import main as train_main
from gennerf_tpu_torch.train.loop import Trainer
from gennerf_tpu_torch.train.state import make_optimizer
from gennerf_tpu_torch.train.step import (
    StepDraws, batch_to_device, gen_nerf_forward_loss, train_step,
)
from gennerf_tpu_torch.utils.config import load_experiment_model_config
from gennerf_tpu_torch.utils.port_params import gen_nerf_params_from_flax

import _torch_threads  # noqa: F401  (sizes torch's threads per xdist worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOXEL_DIM = (16, 16, 8)
VS = 0.08
T, H, W = 2, 12, 16
R, N_STRAT, M_GAUSS = 16, 5, 3
PRESAMPLE = 96
ORIGIN = np.array([0.04, -0.08, 0.02], np.float32)
POINTNET = {"num_sparse_points": 48, "fps_presample": PRESAMPLE, "normalize_coords": True,
            "c_dim": 16, "hidden_dim": 16, "plane_resolution": 32, "n_blocks": 2, "unet": True,
            "unet_kwargs": {"depth": 2, "merge_mode": "concat", "start_filts": 16}}
SPATIAL = {"backbone": "resnet18", "num_layers": 2, "feature_scale": 1.0, "blur_image": False,
           "out_channels": 16}


def _cfg(spatial: bool = False) -> dict:
    return {
        "type": "GenNerf", "voxel_size": VS, "voxel_dim_train": list(VOXEL_DIM),
        "voxel_dim_val": list(VOXEL_DIM), "voxel_dim_test": list(VOXEL_DIM),
        "encoder": {"use_spatial": spatial, "spatial": SPATIAL, "use_pointnet": True,
                    "pointnet": POINTNET},
        "mlp": {"d_out_sem": 1, "d_out_geo": 8, "n_blocks": 2, "d_hidden": 32, "alpha": 0.7,
                "head_smoothing": 1.05},
        "code": {"num_freqs": 6, "freq_factor": 0.5, "include_input": True},
        "ray": {"num_rays": R, "N": N_STRAT, "M": M_GAUSS},
        "loss": {"use_tsdf": True, "tsdf": {"weight": 1.0, "transform": "smooth_log",
                                            "shift": 15.0, "smoothness": 10.0}},
        "optimizer": {"type": "Adam", "lr": 0.001, "weight_decay": 0.0001},
    }


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.fixture(autouse=True)
def _f32_highest():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with jax.default_matmul_precision("highest"):
        yield


def _randomize(params: dict, stats: dict, seed: int):
    """numpy copies of flax variables with every zero-init Dense_1 and the
    BatchNorm parameters and statistics drawn at random, alpha 0.7."""
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
    params["mlp"]["alpha"] = np.asarray(0.7, np.float32)
    return params, stats


@pytest.fixture(scope="module")
def batch():
    return training_batch(1, T, H, W, VOXEL_DIM, VS, seed=3)


def _variables(cfg: dict, batch) -> tuple:
    task = GenNerfTask(cfg)
    variables = jax.jit(task.model.init, static_argnums=(6,))(
        jax.random.PRNGKey(0), *(jnp.asarray(batch[k]) for k in ("projection", "image", "depth")),
        jnp.zeros((1, 8, 3)), jax.random.PRNGKey(0), VOXEL_DIM, jnp.zeros(3))
    return _randomize(dict(variables["params"]), dict(variables.get("batch_stats", {})), 5)


@pytest.fixture(scope="module")
def weights(batch):
    """Randomized JAX variables of the pointnet-only and the spatial configs."""
    return {False: _variables(_cfg(False), batch), True: _variables(_cfg(True), batch)}


def _port(weights, spatial=False, dtype=torch.float32) -> GenNerf:
    params, stats = weights[spatial]
    model = GenNerf(config_from_dict(GenNerfConfig, _cfg(spatial)), dtype=dtype)
    model.load_state_dict(gen_nerf_params_from_flax(params, stats or None))
    return model.eval()


def _jmodel(spatial=False, dtype=jnp.float32):
    return GenNerfTask(_cfg(spatial), None if dtype == jnp.float32 else "bf16-mixed").model


def _near(ours, ref16, ref32, share: float, floor: float = 0.0, name=""):
    """mean|ours - ref16| <= share * mean|ref16 - ref32| and max|ours - ref16|
    <= max|ref16 - ref32| (each + floor * max|ref32|); see the module
    docstring."""
    o, a, b = _np(ours), _np(ref16), _np(ref32)
    assert o.shape == a.shape, name
    gap, err = np.abs(a - b), np.abs(o - a)
    tol = floor * np.abs(b).max()
    assert err.mean() <= share * gap.mean() + tol, (name, err.mean(), gap.mean())
    assert err.max() <= gap.max() + tol, (name, err.max(), gap.max())


def _encode_draws(key, BT, npix, presample=PRESAMPLE):
    key_fps, k_pre = jax.random.split(key)
    return (_t(jax.random.randint(k_pre, (BT, presample), 0, npix)),
            _t(jax.random.randint(key_fps, (BT,), 0, presample)))


def _step_draws(key, BT=T, npix=H * W):
    k_enc, k_sample = jax.random.split(key)
    sel, start = _encode_draws(k_enc, BT, npix)
    k_pix, k_pts = jax.random.split(k_sample)
    return StepDraws(sel=sel, start=start, scores=_t(jax.random.uniform(k_pix, (BT, npix))),
                     noise=_t(jax.random.normal(k_pts, (BT, R, M_GAUSS))))


# -- the modules ---------------------------------------------------------------

@pytest.mark.parametrize("reduce", ["max", "mean"])
def test_scatter_dtypes_match_jax(rng, reduce):
    """bf16 features through the pooling and the plane scatter: the values
    and dtypes of each step against the JAX functions (segment sums in
    float32, returned in bf16; the mean over float32 counts float32; the
    max from -inf in bf16)."""
    from gennerf_tpu.ops import scatter as js
    from gennerf_tpu_torch.ops import scatter as ts

    values = rng.standard_normal((2, 60, 5)).astype(np.float32)
    index = rng.integers(0, 16, (2, 60))
    jv, tv = jnp.asarray(values).astype(jnp.bfloat16), _t(values).to(torch.bfloat16)
    for name, jf, tf in (
            ("segment_sum", js.segment_sum, ts.segment_sum),
            ("segment_mean", js.segment_mean, ts.segment_mean),
            ("segment_max", js.segment_max, ts.segment_max)):
        ref, ours = jf(jv, jnp.asarray(index), 16), tf(tv, _t(index), 16)
        assert str(ours.dtype).split(".")[-1] == str(ref.dtype), name
        np.testing.assert_array_equal(_np(ours), _np(ref), err_msg=name)
    ref = js.pool_and_gather(jv, jnp.asarray(index), 16, reduce)
    ours = ts.pool_and_gather(tv, _t(index), 16, reduce)
    assert str(ours.dtype).split(".")[-1] == str(ref.dtype)
    np.testing.assert_array_equal(_np(ours), _np(ref))
    ref = js.scatter_to_plane(jv, jnp.asarray(index), 4, reduce)
    ours = ts.scatter_to_plane(tv, _t(index), 4, reduce)
    assert str(ours.dtype).split(".")[-1] == str(ref.dtype)
    np.testing.assert_array_equal(_np(ours), _np(ref))


def test_resnetfc_bf16(weights, rng):
    params = weights[False][0]
    zx = rng.standard_normal((2, 300, 39 + 16)).astype(np.float32)
    ref = {dt: JResnetFC(d_in=16, d_out=9, n_blocks=2, d_latent=39, d_hidden=32, alpha=0.7,
                         dtype=dt).apply({"params": params["mlp"]}, jnp.asarray(zx))
           for dt in (jnp.float32, jnp.bfloat16)}
    ours = _port(weights, dtype=torch.bfloat16).mlp(_t(zx))
    assert ours.dtype == torch.float32 and ref[jnp.bfloat16].dtype == jnp.float32
    _near(ours, ref[jnp.bfloat16], ref[jnp.float32], 0.25)


def test_unet_bf16(weights, rng):
    params = weights[False][0]
    x = rng.standard_normal((3, 16, 32, 32)).astype(np.float32)
    ref = {dt: JUNet(16, depth=2, start_filts=16, dtype=dt).apply(
        {"params": params["pointnet"]["unet"]}, jnp.asarray(x)) for dt in (jnp.float32, jnp.bfloat16)}
    ours = _port(weights, dtype=torch.bfloat16).pointnet.unet(_t(x))
    assert ours.dtype == torch.bfloat16 and ref[jnp.bfloat16].dtype == jnp.bfloat16
    _near(ours, ref[jnp.bfloat16], ref[jnp.float32], 0.25)


def test_pointnet_bf16(weights, rng):
    """Points in and beyond the padded cube (cells shared, border clamps)."""
    params = weights[False][0]
    p = rng.uniform(-0.6, 0.6, (1, 300, 3)).astype(np.float32)
    ref = {}
    for dt in (jnp.float32, jnp.bfloat16):
        m = JPointnet(c_dim=16, hidden_dim=16, use_unet=True, unet_depth=2, unet_start_filts=16,
                      plane_resolution=32, n_blocks=2, dtype=dt)
        with jax.disable_jit():
            ref[dt] = m.apply({"params": params["pointnet"]}, jnp.asarray(p))
    ours = _port(weights, dtype=torch.bfloat16).pointnet(_t(p))
    for k in ("xz", "xy", "yz"):
        assert ours[k].dtype == torch.bfloat16 and ref[jnp.bfloat16][k].dtype == jnp.bfloat16
        _near(ours[k], ref[jnp.bfloat16][k], ref[jnp.float32][k], 0.25, name=k)


@pytest.mark.parametrize("spatial", [False, True], ids=["pointnet", "spatial_pointnet"])
def test_gen_nerf_encode_decode_bf16(weights, batch, rng, spatial):
    """Eval mode: the encode (at a non-zero origin, the JAX draws
    injected), then the decode of JAX's bf16 scene at points in and around
    the volume; the planes bf16, the volume and its counts float32, every
    decode output float32 but the TSDF, bf16, in both frameworks. The
    float32 references run compiled."""
    params, stats = weights[spatial]
    v = {"params": params, "batch_stats": stats}
    key = jax.random.PRNGKey(3)
    sel, start = _encode_draws(key, T, H * W)
    args = [jnp.asarray(batch[k]) for k in ("projection", "image", "depth")]
    xyz = jnp.asarray(rng.uniform(-0.2, 1.4, (1, 80, 3)).astype(np.float32))
    origin = jnp.asarray(ORIGIN)

    def encode(model):
        return model.apply(v, *args, key, VOXEL_DIM, origin, train=False, method=JGenNerf.encode)

    def decode(model, repr_):
        return model.apply(v, repr_, xyz, origin, method=JGenNerf.decode)

    with jax.disable_jit():
        r16 = encode(_jmodel(spatial, jnp.bfloat16))
        d16 = decode(_jmodel(spatial, jnp.bfloat16), r16)
    r32 = jax.jit(lambda: encode(_jmodel(spatial)))()
    d32 = jax.jit(lambda r: decode(_jmodel(spatial), r))(r16)
    model = _port(weights, spatial, torch.bfloat16)
    with torch.no_grad():
        ours = model.encode(*(_t(batch[k]) for k in ("projection", "image", "depth")),
                            sel=sel, start=start, voxel_dim=VOXEL_DIM, origin=_t(ORIGIN))
        scene = SceneRepr({k: _t(a.astype(jnp.float32)).to(torch.bfloat16)
                           for k, a in r16.planes.items()},
                          None if r16.volume is None else _t(r16.volume),
                          None if r16.valid is None else _t(r16.valid))
        dec = model.decode(scene, _t(xyz), _t(ORIGIN))
    for k in ("xz", "xy", "yz"):
        assert ours.planes[k].dtype == torch.bfloat16 and r16.planes[k].dtype == jnp.bfloat16
        _near(ours.planes[k], r16.planes[k], r32.planes[k], 0.25, name=k)
    if spatial:
        assert ours.volume.dtype == torch.float32 and r16.volume.dtype == jnp.float32
        _near(ours.volume, r16.volume, r32.volume, 0.25, name="volume")
        np.testing.assert_array_equal(ours.valid.numpy(), np.asarray(r16.valid))
    for k in ("feat", "feat_geo", "feat_sem", "tsdf"):
        assert str(dec[k].dtype).split(".")[-1] == str(d16[k].dtype), k
        _near(dec[k], d16[k], d32[k], 0.25, name=k)
    assert dec["tsdf"].dtype == torch.bfloat16 and dec["feat"].dtype == torch.float32


def test_decode_dense_bf16(weights, batch, rng):
    """decode_dense of a bf16 model samples the scene in bf16 and returns
    float32, against the JAX decode_dense (op by op) of the same scene."""
    params, stats = weights[True]
    key = jax.random.PRNGKey(4)
    args = [jnp.asarray(batch[k]) for k in ("projection", "image", "depth")]
    v = {"params": params, "batch_stats": stats}
    repr_j = jax.jit(lambda: _jmodel(True).apply(v, *args, key, VOXEL_DIM, jnp.zeros(3),
                                                 train=False, method=JGenNerf.encode))()
    pts = rng.uniform(-0.1, 1.3, (700, 3)).astype(np.float32)
    ref = {jnp.float32: j_decode_dense(_jmodel(True), v, repr_j, jnp.asarray(pts), jnp.zeros(3),
                                       chunk_size=256)}
    with jax.disable_jit():
        ref[jnp.bfloat16] = j_decode_dense(_jmodel(True, jnp.bfloat16), v, repr_j,
                                           jnp.asarray(pts), jnp.zeros(3), chunk_size=350)
    repr_t = SceneRepr({k: _t(a) for k, a in repr_j.planes.items()}, _t(repr_j.volume),
                       _t(repr_j.valid))
    ours = tpred.decode_dense(_port(weights, True, torch.bfloat16), repr_t, _t(pts),
                              chunk_size=256)
    assert ours.dtype == torch.float32 and ours.shape == (700,)
    assert ref[jnp.bfloat16].dtype == jnp.bfloat16
    _near(ours, ref[jnp.bfloat16], ref[jnp.float32], 0.25)


def test_reconstruct_bf16_returns_float32(weights, batch):
    """reconstruct of a bf16 pointnet model: the grid decode's tables from
    the bf16 planes (float32 volume), against the plain bf16-feed decode of
    the same scene and the float32 model's volume."""
    model = _port(weights, False, torch.bfloat16)
    args = [batch[k][0] for k in ("projection", "image", "depth")]
    draws = _encode_draws(jax.random.PRNGKey(5), T, H * W)
    vol = reconstruct(model, *args, sel=draws[0], start=draws[1])
    vol32 = reconstruct(_port(weights, False), *args, sel=draws[0], start=draws[1])
    assert vol.dtype == torch.float32 and vol.shape == VOXEL_DIM
    assert torch.isfinite(vol).all()
    assert float((vol - vol32).abs().max()) < 0.1


# -- a train step ----------------------------------------------------------------

def test_train_step_bf16_matches_jax(weights, batch):
    """One bf16-mixed step's loss, metrics and every gradient against
    jax.value_and_grad of the JAX forward loss in bf16 (op by op)."""
    params, _ = weights[False]
    key = jax.random.PRNGKey(11)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    cfg = GenNerfTask(_cfg(False)).cfg

    def value_and_grad(dt):
        def f(p):
            loss, metrics, _ = j_forward_loss(_jmodel(False, dt), cfg, p, {}, jbatch, key,
                                              VOXEL_DIM, True)
            return loss, metrics

        return jax.value_and_grad(f, has_aux=True)(jax.tree.map(jnp.asarray, params))

    ref = {jnp.float32: jax.jit(lambda: value_and_grad(jnp.float32))()}
    ref[jnp.bfloat16] = jax.jit(lambda: value_and_grad(jnp.bfloat16))()
    (l16, m16), g16 = ref[jnp.bfloat16]
    (l32, m32), g32 = ref[jnp.float32]
    model = _port(weights, False, torch.bfloat16).train()
    loss, metrics = gen_nerf_forward_loss(model, batch_to_device(batch, "cpu"),
                                          draws=_step_draws(key))
    loss.backward()
    assert loss.dtype == torch.float32 and set(metrics) == set(m16)
    for k in m16:
        _near(metrics[k], m16[k], m32[k], 0.5, floor=1e-7, name=k)
    g16 = gen_nerf_params_from_flax(jax.tree.map(np.asarray, g16))
    g32 = gen_nerf_params_from_flax(jax.tree.map(np.asarray, g32))
    for name, p in model.named_parameters():
        assert p.grad.dtype == torch.float32, name
        _near(p.grad, g16[name], g32[name], 0.5, floor=1e-6, name=name)


def test_bf16_step_keeps_float32_state(weights, batch):
    """A bf16 train_step: the loss finite, every parameter, gradient and
    optimizer moment float32, and the parameters moved."""
    model = _port(weights, True, torch.bfloat16)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = make_optimizer(model.parameters(), model.cfg.optimizer)
    metrics = train_step(model, opt, batch_to_device(batch, "cpu"), draws=_step_draws(
        jax.random.PRNGKey(2)))
    assert np.isfinite(float(metrics["combined"]))
    assert all(v.dtype == torch.float32 for v in model.state_dict().values())
    assert all(p.grad.dtype == torch.float32 for p in model.parameters())
    assert all(t.dtype == torch.float32 for s in opt.state.values() for t in s.values()
               if isinstance(t, torch.Tensor) and t.is_floating_point())
    assert not torch.equal(before["mlp.lin_in.weight"], model.state_dict()["mlp.lin_in.weight"])


def test_bf16_loss_near_float32(weights, batch):
    """The same weights, batch and draws in bf16 and in float32: the loss
    within 2e-2 relative."""
    draws = _step_draws(jax.random.PRNGKey(6))
    tb = batch_to_device(batch, "cpu")
    losses = []
    for dtype in (torch.bfloat16, torch.float32):
        with torch.no_grad():
            losses.append(float(gen_nerf_forward_loss(_port(weights, False, dtype).train(), tb,
                                                      draws=draws)[0]))
    assert abs(losses[0] - losses[1]) <= 2e-2 * abs(losses[1]), losses


# -- precision surface -------------------------------------------------------------

def test_trainer_refuses_a_precision_mismatch(weights):
    """The reference loop's rule: trainer.precision must map to the
    model's compute dtype."""
    model = _port(weights, False)
    opt = make_optimizer(model.parameters(), model.cfg.optimizer)
    with pytest.raises(ValueError, match="bf16-mixed"):
        Trainer(model, opt, torch.Generator(), precision="bf16-mixed")
    m16 = _port(weights, False, torch.bfloat16)
    Trainer(m16, make_optimizer(m16.parameters(), m16.cfg.optimizer), torch.Generator(),
            precision="16-mixed")


FLAGSHIP = ("seq1_frames8_evenspaced_pointnet", "seq1_frames8_evenspaced_eikonal",
            "train_tsdf_one_scene_seqs1_framesN")


@pytest.mark.parametrize("name", FLAGSHIP)
def test_flagship_configs_step_in_bf16(name):
    """The flagship and its two children at full width build in bf16 and
    take one step on a synthetic batch (their training grids cut to
    32x32x16 for the CPU; 8 frames of 24x32)."""
    cfg = config_from_dict(GenNerfConfig, load_experiment_model_config(
        os.path.join(REPO, "configs", "experiment", name + ".yaml")))
    p = cfg.encoder.pointnet
    assert (p.c_dim, p.hidden_dim, p.n_blocks, p.plane_resolution, p.unet_depth,
            p.unet_start_filts, p.num_sparse_points, p.normalize_coords) == (
        64, 32, 4, 128, 3, 32, 512, False)
    assert (cfg.mlp.d_hidden, cfg.mlp.n_blocks, cfg.code.num_freqs) == (256, 5, 6)
    assert (cfg.ray.num_rays, cfg.ray.N, cfg.ray.M) == (100, 20, 8)
    assert (cfg.optimizer.lr, cfg.optimizer.weight_decay, cfg.scheduler.step_size) == (
        1e-4, 1e-4, 300 if name.endswith("framesN") else 400)
    cfg = dataclasses.replace(cfg, voxel_dim_train=(32, 32, 16))
    torch.manual_seed(0)
    model = GenNerf(cfg, dtype=torch.bfloat16)
    b = batch_to_device(training_batch(1, 8, 24, 32, (32, 32, 16), cfg.voxel_size, seed=1), "cpu")
    opt = make_optimizer(model.parameters(), cfg.optimizer)
    metrics = train_step(model, opt, b, torch.Generator().manual_seed(0))
    assert all(np.isfinite(float(v)) for v in metrics.values())
    expect = {"seq1_frames8_evenspaced_pointnet": set(),
              "seq1_frames8_evenspaced_eikonal": {"eikonal"},
              "train_tsdf_one_scene_seqs1_framesN": set()}[name]
    assert {"eikonal", "gradient"} & set(metrics) == expect
    if name.endswith("framesN"):
        assert cfg.sampling_mode == "frustum"


# -- the CLIs ------------------------------------------------------------------------

TINY_BF16 = (
    "defaults:\n  - seqs_multigeo_4cm\n"
    "model:\n  encoder:\n    pointnet:\n      num_sparse_points: 32\n      fps_presample: 64\n"
    "      c_dim: 8\n      hidden_dim: 8\n      plane_resolution: 16\n      n_blocks: 2\n"
    "      unet_kwargs: {depth: 2, merge_mode: concat, start_filts: 8}\n"
    "  mlp: {d_out_geo: 8, d_out_sem: 1, n_blocks: 2, d_hidden: 32}\n"
    "  ray: {num_rays: 8, N: 4, M: 2}\n"
    "trainer: {precision: bf16-mixed, log_every_n_steps: 1, check_val_every_n_epoch: 1}\n"
    "data:\n  voxel_size: 0.08\n  voxel_dim_train: [16, 16, 8]\n  voxel_dim_val: [16, 16, 8]\n"
    "  voxel_dim_test: [24, 24, 16]\n  num_frames_train: 2\n  num_frames_val: 2\n"
    "  num_frames_test: 2\n  sequence_length: 3\n  num_workers_train: 0\n"
    "  num_workers_val: 0\n  num_workers_test: 0\n")


def test_train_predict_render_clis_bf16(tmp_path):
    """A child of seqs_multigeo_4cm under bf16-mixed: the train CLI trains
    one epoch in bf16 (monitored checkpoints, params.npz), the predict CLI
    reloads the run's best epoch into a bf16 model and records the
    precision, the render CLI renders a held-out scene through it."""
    from gennerf_tpu_torch.data.synthetic import generate_scene, random_primitives

    root = str(tmp_path / "data")
    rng = np.random.default_rng(0)
    infos = [os.path.relpath(generate_scene(root, scene=f"scene_{fam}", num_frames=3, H=24, W=32,
                                            voxel_sizes=(8,), seed=i,
                                            primitives=random_primitives(rng, fam)), root)
             for i, fam in enumerate(("spheres", "boxes"))]
    for split in ("train.txt", "val.txt"):
        with open(os.path.join(root, split), "w") as f:
            f.write("\n".join(infos) + "\n")
    shutil.copytree(os.path.join(REPO, "configs"), tmp_path / "configs")
    exp = tmp_path / "configs" / "experiment" / "tiny_bf16.yaml"
    exp.write_text(TINY_BF16)
    run = tmp_path / "run"
    trainer = train_main(["--config", str(exp), "--out", str(run), "--data-dir", root,
                          "--epochs", "1", "--device", "cpu"])
    assert trainer.model.dtype == torch.bfloat16 and trainer.global_step == 2
    assert np.isfinite(trainer.metrics["val_recon_tsdf_l1"])
    pred = tmp_path / "pred"
    results = predict_main(["--config", str(exp), "--ckpt", str(run), "--data-dir", root,
                            "--split", "val.txt", "--out", str(pred), "--device", "cpu"])
    assert len(results) == 2
    with open(pred / "predict_meta.json") as f:
        meta = __import__("json").load(f)
    assert meta["precision"] == "bf16-mixed" and meta["selected_by"] == "val_combined"
    mean = render_main(["--config", str(exp), "--ckpt", str(run), "--data-dir", root,
                        "--split", "val.txt", "--out", str(tmp_path / "views"), "--num-views", "1",
                        "--device", "cpu"])
    assert set(mean) and os.path.exists(tmp_path / "views" / "render_metrics.json")
