"""The GenNerf options a reference checkpoint can name, in the port against
the JAX package on the CPU: ResnetFC with SPADE and LayerNorm, the UNet's
'add' merge, the learned plane merger, UNet3D and the 'grid' plane, and
each option in a whole GenNerf encode and decode (its draws injected).
tests/test_torch_options_steps.py holds the voxel_hash sparsifier,
PointNet++ and a train step with the options on.

Sizes are small (2 frames of 12x16, c_dim 8, H 32, 2 blocks, 16x16
planes, an 8^3 grid with a 2-level UNet3D of 4 maps). JAX runs under
default_matmul_precision("highest"), the port with TF32 off. The JAX
draws are injected into the port: the presample from split(key)[1] and
the sparsifier's draw from split(key)[0] (the FPS start, or voxel_hash's
uniform scores).

Tolerances, float32: modules and whole-model outputs within 1e-5 of the
reference's largest magnitude (another summation order through a few
layers; flax's LayerNorm and GroupNorm take E[x^2] - E[x]^2 and epsilon
1e-6, which the port copies).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gennerf_tpu.models.gen_nerf import GenNerf as JGenNerf
from gennerf_tpu.models.pointnet import FeaturePlaneMerger as JMerger
from gennerf_tpu.models.resnetfc import ResnetFC as JResnetFC
from gennerf_tpu.models.unet import UNet as JUNet
from gennerf_tpu.models.unet3d import UNet3D as JUNet3D
from gennerf_tpu.train.tasks import GenNerfTask
from gennerf_tpu_torch.data.synthetic import training_batch
from gennerf_tpu_torch.models.config import GenNerfConfig, config_from_dict
from gennerf_tpu_torch.models.gen_nerf import GenNerf, SceneRepr
from gennerf_tpu_torch.models.resnetfc import ResnetFC
from gennerf_tpu_torch.utils.port_params import gen_nerf_params_from_flax

VD = (16, 16, 8)
T, H, W, PRESAMPLE = 2, 12, 16, 64
R, M_GAUSS = 16, 3
CFG = {
    "type": "GenNerf", "voxel_size": 0.08,
    "voxel_dim_train": list(VD), "voxel_dim_val": list(VD), "voxel_dim_test": list(VD),
    "encoder": {
        "use_spatial": False, "use_pointnet": True,
        "pointnet": {"num_sparse_points": 32, "fps_presample": PRESAMPLE,
                     "normalize_coords": True, "c_dim": 8, "hidden_dim": 8,
                     "plane_resolution": 16, "n_blocks": 2, "unet": True,
                     "unet_kwargs": {"depth": 2, "merge_mode": "concat", "start_filts": 8}},
    },
    "mlp": {"d_out_sem": 1, "d_out_geo": 8, "n_blocks": 2, "d_hidden": 32, "alpha": 0.7},
    "code": {"num_freqs": 6, "freq_factor": 0.5, "include_input": True},
    "ray": {"num_rays": R, "N": 5, "M": M_GAUSS},
    "loss": {"use_tsdf": True, "tsdf": {"weight": 1.0, "transform": "smooth_log",
                                        "shift": 15.0, "smoothness": 10.0}},
    "optimizer": {"type": "Adam", "lr": 0.001, "weight_decay": 0.0001},
}
GRID = {"plane_type": ["xz", "xy", "yz", "grid"], "grid_resolution": 8, "unet3d": True,
        "unet3d_f_maps": 4, "unet3d_num_levels": 2}
OPTIONS = {
    "spade": {"mlp": {"use_spade": True}},
    "layer_norm": {"mlp": {"use_layer_norm": True}},
    "learn": {"encoder": {"plane_merger": {"strategy": "learn"}}},
    "add": {"encoder": {"pointnet": {"unet_kwargs": {"merge_mode": "add"}}}},
    "grid": {"encoder": {"pointnet": GRID}},
    "voxel_hash": {"encoder": {"pointnet": {"sparsifier": "voxel_hash"}}},
}
TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _merge(a, b):
    out = dict(a)
    for k, v in b.items():
        out[k] = _merge(a.get(k, {}), v) if isinstance(v, dict) else v
    return out


def _close(ours, ref, tol=TOL):
    ref = np.asarray(ref, np.float32)
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=tol * max(float(np.abs(ref).max()), 1e-30))


@pytest.fixture(autouse=True)
def _f32_highest():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with jax.default_matmul_precision("highest"):
        yield


def _frames(seed=0):
    b = training_batch(1, T, H, W, VD, 0.08, seed=seed)
    return b


def _randomize(tree, rng):
    """Every residual block's zero-init fc_1 and every norm's scale and
    bias drawn at random."""
    for k, v in tree.items():
        if not isinstance(v, dict):
            continue
        if k == "Dense_1":
            v["kernel"] = (0.2 * rng.standard_normal(v["kernel"].shape)).astype(np.float32)
            v["bias"] = (0.1 * rng.standard_normal(v["bias"].shape)).astype(np.float32)
        elif "scale" in v:
            v["scale"] = rng.uniform(0.5, 1.5, v["scale"].shape).astype(np.float32)
            v["bias"] = (0.1 * rng.standard_normal(v["bias"].shape)).astype(np.float32)
        else:
            _randomize(v, rng)
    return tree


def _init_all(m, projection, image, depth, xyz, key, voxel_dim, origin):
    """Encode, merge and decode: touches every parameter (flax creates the
    learned merger's at the first merge)."""
    r = m.encode(projection, image, depth, key, voxel_dim, origin)
    return m.decode(m.merge(r, r), xyz, origin)


_CACHE = {}


def pair(name):
    """(JAX model, its randomized params, the port model with them) of
    CFG with option `name` on."""
    if name not in _CACHE:
        cfg = _merge(CFG, OPTIONS[name])
        jtask = GenNerfTask(cfg)
        b = _frames()
        with jax.default_matmul_precision("highest"):
            variables = jax.jit(functools.partial(jtask.model.init, method=_init_all),
                                static_argnums=(6,))(
                jax.random.PRNGKey(0), jnp.asarray(b["projection"]), jnp.asarray(b["image"]),
                jnp.asarray(b["depth"]), jnp.zeros((1, 8, 3)), jax.random.PRNGKey(1), VD,
                jnp.zeros(3))
        tree = _randomize(jax.tree.map(lambda a: np.array(a, np.float32),
                                       dict(variables["params"])), np.random.default_rng(7))
        tree["mlp"]["alpha"] = np.asarray(0.7, np.float32)
        model = GenNerf(config_from_dict(GenNerfConfig, cfg))
        model.load_state_dict(gen_nerf_params_from_flax(tree))
        _CACHE[name] = (jtask, tree, model.eval())
    return _CACHE[name]


def _encode_draws(key, sparsifier="fps", BT=T, npix=H * W):
    """The JAX encode's draws from `key`: the presample and the sparsifier's."""
    key_sparse, k_pre = jax.random.split(key)
    sel = _t(jax.random.randint(k_pre, (BT, PRESAMPLE), 0, npix))
    if sparsifier == "voxel_hash":
        return sel, _t(jax.random.uniform(key_sparse, (BT, PRESAMPLE)))
    return sel, _t(jax.random.randint(key_sparse, (BT,), 0, PRESAMPLE))


# -- modules -----------------------------------------------------------------------

@pytest.mark.parametrize("spade,layer_norm", [(True, False), (False, True), (True, True)],
                         ids=["spade", "layer_norm", "both"])
def test_resnetfc_spade_layer_norm(spade, layer_norm):
    rng = np.random.default_rng(1)
    d_code, d_in = 39, 8
    zx = rng.standard_normal((64, d_code + d_in)).astype(np.float32)
    jm = JResnetFC(d_in=d_in, d_out=9, n_blocks=3, d_latent=d_code, d_hidden=32, alpha=0.7,
                   use_spade=spade, use_layer_norm=layer_norm)
    params = _randomize(jax.tree.map(lambda a: np.array(a, np.float32), dict(
        jm.init(jax.random.PRNGKey(2), jnp.asarray(zx))["params"])), rng)
    params["alpha"] = np.asarray(0.7, np.float32)
    ref = jm.apply({"params": params}, jnp.asarray(zx))
    ours = ResnetFC(d_in, 9, 3, d_code, 32, alpha=0.7, use_spade=spade,
                    use_layer_norm=layer_norm)
    state = gen_nerf_params_from_flax({"mlp": params, "head_geo": {"Dense_0": {
        "kernel": np.zeros((8, 1), np.float32), "bias": np.zeros(1, np.float32)}}})
    ours.load_state_dict({k[4:]: v for k, v in state.items() if k.startswith("mlp.")})
    assert (ours.scale_z is not None) == spade and (ours.ln is not None) == layer_norm
    _close(ours(_t(zx)), ref)


def test_unet_add_merge():
    """'add' sums the up path and the skip: each up block's first conv
    takes c channels, not 2c."""
    _, tree, model = pair("add")
    x = np.random.default_rng(2).standard_normal((3, 8, 16, 16)).astype(np.float32)
    ref = jax.jit(JUNet(8, depth=2, start_filts=8, merge_mode="add").apply)(
        {"params": tree["pointnet"]["unet"]}, jnp.asarray(x))
    assert model.pointnet.unet.up_convs[0].conv1.in_channels == 8
    _close(model.pointnet.unet(_t(x)), ref)


def test_learned_merger():
    _, tree, model = pair("learn")
    rng = np.random.default_rng(3)
    a, b = ({k: rng.standard_normal((1, 8, 16, 16)).astype(np.float32) for k in ("xz", "xy", "yz")}
            for _ in range(2))
    ref = JMerger(strategy="learn", c_dim=8).apply(
        {"params": tree["merger"]}, {k: jnp.asarray(v) for k, v in a.items()},
        {k: jnp.asarray(v) for k, v in b.items()})
    ours = model.merge(SceneRepr({k: _t(v) for k, v in a.items()}),
                       SceneRepr({k: _t(v) for k, v in b.items()})).planes
    for k in ref:
        _close(ours[k], ref[k])


@pytest.mark.parametrize("shape", [(8, 8, 8), (4, 8, 12)], ids=["cube", "box"])
def test_unet3d(shape):
    """A cube and a box (sizes even at every pooled level: the JAX module's
    floor pool and crop fail to concatenate an odd level, as the port's do)."""
    _, tree, model = pair("grid")
    x = np.random.default_rng(4).standard_normal((2, 8, *shape)).astype(np.float32)
    ref = jax.jit(JUNet3D(8, f_maps=4, num_levels=2).apply)(
        {"params": tree["pointnet"]["unet3d"]}, jnp.asarray(x))
    _close(model.pointnet.unet3d(_t(x)), ref)


# -- the options in a whole GenNerf ---------------------------------------------------

@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_gen_nerf_with_option(name):
    """Encode with the JAX draws injected (every plane, the grid too), then
    a decode of the JAX encoding at points over and past the volume, and
    for 'learn' the merge of two encodes."""
    jtask, tree, model = pair(name)
    jm = jtask.model
    b = _frames(seed=1)
    key = jax.random.PRNGKey(3)
    sel, start = _encode_draws(key, model.cfg.encoder.pointnet.sparsifier)
    args = tuple(jnp.asarray(b[k]) for k in ("projection", "image", "depth"))
    ref = jax.jit(functools.partial(jm.apply, method=JGenNerf.encode), static_argnums=(5,))(
        {"params": tree}, *args, key, VD, jnp.zeros(3))
    ours = model.encode(*(_t(b[k]) for k in ("projection", "image", "depth")), sel=sel,
                        start=start)
    assert set(ours.planes) == set(ref.planes)
    for k in ref.planes:
        _close(ours.planes[k], ref.planes[k])
    xyz = np.random.default_rng(5).uniform(-0.1, 1.4, (1, 200, 3)).astype(np.float32)
    out_j = jax.jit(functools.partial(jm.apply, method=JGenNerf.decode))(
        {"params": tree}, ref, jnp.asarray(xyz), jnp.zeros(3))
    planes = {k: _t(v) for k, v in ref.planes.items()}
    out = model.decode(SceneRepr(planes), _t(xyz))
    for k in ("feat", "feat_geo", "feat_sem", "tsdf"):
        _close(out[k], out_j[k])
    if name == "learn":
        merged_j = jm.apply({"params": tree}, ref, ref, method=JGenNerf.merge)
        merged = model.merge(SceneRepr(planes), SceneRepr(planes))
        for k in planes:
            _close(merged.planes[k], merged_j.planes[k])
