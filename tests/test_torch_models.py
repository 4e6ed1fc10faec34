"""Parity of the port's models (gennerf_tpu_torch.models) with the JAX
package on the CPU, at a small width (2 frames of 12x16, c_dim 8, H 32,
2 blocks).

The JAX model is initialized by flax, its Dense_1 kernels (zero at init)
are randomized, alpha != 1 and head_smoothing != 1, and its params go into
the port through gen_nerf_params_from_flax. JAX runs at "highest" matmul
precision (this build's default f32 matmul is bf16-level) and TF32 is off
on the torch side. Outputs agree within 1e-4 absolute: float32 in another
summation order through several layers.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gennerf_tpu.models.config import GenNerfConfig as JConfig
from gennerf_tpu.models.config import config_from_dict as j_config_from_dict
from gennerf_tpu.models.gen_nerf import GenNerf as JGenNerf
from gennerf_tpu.models.heads import TSDFHeadSimple as JHead
from gennerf_tpu.models.pointnet import LocalPoolPointnet as JPointnet
from gennerf_tpu.models.resnetfc import ResnetFC as JResnetFC
from gennerf_tpu.models.unet import UNet as JUNet
from gennerf_tpu.utils.config import compose as j_compose
from gennerf_tpu_torch.data.synthetic import look_at_pose
from gennerf_tpu_torch.models.config import GenNerfConfig, check_supported, config_from_dict
from gennerf_tpu_torch.models.gen_nerf import GenNerf, SceneRepr
from gennerf_tpu_torch.models.resnetfc import ResnetFC
from gennerf_tpu_torch.utils.config import compose, load_experiment_model_config
from gennerf_tpu_torch.utils.port_params import (
    gen_nerf_params_from_flax,
    load_params_npz,
    save_params_npz,
)

import _torch_threads  # noqa: F401  (sizes torch's threads per xdist worker)

ATOL = 1e-4

SMALL_CFG = {
    "type": "GenNerf", "voxel_size": 0.08,
    "voxel_dim_train": [16, 16, 8], "voxel_dim_val": [16, 16, 8], "voxel_dim_test": [16, 16, 8],
    "encoder": {
        "use_spatial": False, "use_pointnet": True,
        "pointnet": {"num_sparse_points": 32, "fps_presample": 64, "normalize_coords": True,
                     "c_dim": 8, "hidden_dim": 8, "plane_resolution": 16, "n_blocks": 2,
                     "unet": True, "unet_kwargs": {"depth": 2, "merge_mode": "concat",
                                                   "start_filts": 8}},
    },
    "mlp": {"d_out_sem": 1, "d_out_geo": 8, "n_blocks": 2, "d_hidden": 32,
            "alpha": 0.7, "head_smoothing": 1.05},
    "code": {"num_freqs": 6, "freq_factor": 0.5, "include_input": True},
}


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol, rtol=0)


def _frames(T=2, H=12, W=16, seed=0):
    """Ring cameras around the training volume's center; depth in [0.8, 2.2]."""
    rng = np.random.default_rng(seed)
    f = 0.6 * W
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    P = []
    for i in range(T):
        ang = 2 * np.pi * i / T + 0.3
        pose = look_at_pose((0.64 + 1.5 * np.cos(ang), 0.64 + 1.5 * np.sin(ang), 1.0), (0.64, 0.64, 0.3))
        P.append((K @ np.linalg.inv(pose)[:3]).astype(np.float32))
    depth = rng.uniform(0.8, 2.2, (1, T, H, W)).astype(np.float32)
    image = rng.uniform(0, 1, (1, T, 3, H, W)).astype(np.float32)
    return np.stack(P)[None], image, depth


def _randomize_dense_1(tree, rng):
    """Dense_1 of every residual block is zero at init; give it values so
    the second product of each block is exercised."""
    for k, v in tree.items():
        if isinstance(v, dict):
            if k == "Dense_1":
                v["kernel"] = (0.2 * rng.standard_normal(v["kernel"].shape)).astype(np.float32)
                v["bias"] = (0.1 * rng.standard_normal(v["bias"].shape)).astype(np.float32)
            else:
                _randomize_dense_1(v, rng)
    return tree


@pytest.fixture(autouse=True)
def _f32_highest():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params tree of numpy arrays, port model) sharing weights."""
    with jax.default_matmul_precision("highest"):
        jcfg = j_config_from_dict(JConfig, SMALL_CFG)
        jmodel = JGenNerf(jcfg)
        P, image, depth = _frames()
        variables = jax.jit(jmodel.init, static_argnums=(6,))(
            jax.random.PRNGKey(0), jnp.asarray(P), jnp.asarray(image), jnp.asarray(depth),
            jnp.zeros((1, 8, 3)), jax.random.PRNGKey(1), (16, 16, 8), jnp.zeros(3))
    tree = _randomize_dense_1(jax.tree.map(np.asarray, dict(variables["params"])), np.random.default_rng(7))
    tree["mlp"]["alpha"] = np.asarray(0.7, np.float32)
    tmodel = GenNerf(config_from_dict(GenNerfConfig, SMALL_CFG))
    tmodel.load_state_dict(gen_nerf_params_from_flax(tree))
    return jmodel, tree, tmodel.eval()


@pytest.mark.parametrize("beta", [0.0, 2.0])  # ReLU, softplus
def test_resnetfc(pair, rng, beta):
    _, tree, tmodel = pair
    d_code = 39
    zx = rng.standard_normal((5, d_code + 8)).astype(np.float32)
    ref = JResnetFC(d_in=8, d_out=9, n_blocks=2, d_latent=d_code, d_hidden=32, alpha=0.7,
                    beta=beta).apply({"params": tree["mlp"]}, jnp.asarray(zx))
    mlp = ResnetFC(8, 9, 2, d_code, 32, beta=beta)
    mlp.load_state_dict(tmodel.mlp.state_dict())
    _close(mlp(_t(zx)), ref)


def test_tsdf_head(pair, rng):
    _, tree, tmodel = pair
    x = rng.standard_normal((6, 8)).astype(np.float32)
    ref = JHead(smoothing=1.05).apply({"params": tree["head_geo"]}, jnp.asarray(x))
    _close(tmodel.head_geo(_t(x)), ref)


def test_unet(pair, rng):
    _, tree, tmodel = pair
    x = rng.standard_normal((3, 8, 16, 16)).astype(np.float32)
    ref = JUNet(8, depth=2, start_filts=8, merge_mode="concat").apply(
        {"params": tree["pointnet"]["unet"]}, jnp.asarray(x))
    _close(tmodel.pointnet.unet(_t(x)), ref)


def test_local_pool_pointnet(pair, rng):
    _, tree, tmodel = pair
    p = rng.uniform(-0.55, 0.55, (2, 64, 3)).astype(np.float32)
    ref = JPointnet(c_dim=8, hidden_dim=8, use_unet=True, unet_depth=2, unet_start_filts=8,
                    plane_resolution=16, n_blocks=2).apply({"params": tree["pointnet"]}, jnp.asarray(p))
    ours = tmodel.pointnet(_t(p))
    assert set(ours) == set(ref) == {"xz", "xy", "yz"}
    for k in ref:
        _close(ours[k], ref[k])


def test_gen_nerf_encode(pair):
    """Whole encode with the JAX draws injected: presample from
    split(key)[1], FPS start from the split-off key."""
    jmodel, tree, tmodel = pair
    P, image, depth = _frames()
    key = jax.random.PRNGKey(3)
    BT, N = 2, 12 * 16
    key_fps, k_pre = jax.random.split(key)
    sel = jax.random.randint(k_pre, (BT, 64), 0, N)
    start = jax.random.randint(key_fps, (BT,), 0, 64)
    ref = jmodel.apply({"params": tree}, jnp.asarray(P), jnp.asarray(image), jnp.asarray(depth),
                       key, (16, 16, 8), jnp.zeros(3), method=JGenNerf.encode)
    ours = tmodel.encode(_t(P), _t(image), _t(depth), sel=_t(sel), start=_t(start))
    for k in ("xz", "xy", "yz"):
        _close(ours.planes[k], ref.planes[k])


def test_gen_nerf_decode(pair, rng):
    jmodel, tree, tmodel = pair
    planes = {k: rng.standard_normal((1, 8, 16, 16)).astype(np.float32) for k in ("xz", "xy", "yz")}
    xyz = rng.uniform(-0.1, 1.4, (1, 50, 3)).astype(np.float32)
    from gennerf_tpu.models.gen_nerf import SceneRepr as JRepr
    ref = jmodel.apply({"params": tree}, JRepr(None, None, {k: jnp.asarray(v) for k, v in planes.items()}),
                       jnp.asarray(xyz), jnp.zeros(3), method=JGenNerf.decode)
    ours = tmodel.decode(SceneRepr({k: _t(v) for k, v in planes.items()}), _t(xyz))
    for k in ("feat", "feat_geo", "feat_sem", "tsdf"):
        _close(ours[k], ref[k])


def test_merge_average(pair, rng):
    _, _, tmodel = pair
    a = {k: _t(rng.standard_normal((1, 8, 4, 4)).astype(np.float32)) for k in ("xz", "xy", "yz")}
    b = {k: _t(rng.standard_normal((1, 8, 4, 4)).astype(np.float32)) for k in ("xz", "xy", "yz")}
    merged = tmodel.merge(SceneRepr(a), SceneRepr(b)).planes
    for k in a:
        torch.testing.assert_close(merged[k], 0.1 * a[k] + 0.9 * b[k])


def test_params_npz_roundtrip(pair, tmp_path):
    _, tree, tmodel = pair
    save_params_npz(str(tmp_path / "p.npz"), tree)
    state = gen_nerf_params_from_flax(load_params_npz(str(tmp_path / "p.npz")))
    for k, v in tmodel.state_dict().items():
        torch.testing.assert_close(state[k], v, rtol=0, atol=0)


def test_compose_matches_jax_compose():
    ours = load_experiment_model_config("configs/experiment/seqs_multigeo_4cm.yaml")
    ref = j_compose("configs", "predict", ["experiment=seqs_multigeo_4cm"])["model"]
    ref.pop("output_dir"), ours.pop("output_dir")  # timestamped run dir
    assert ours == ref
    assert compose("configs", "train", ["experiment=overfit_synthetic"])["model"]["mlp"]["d_hidden"] == 256


def test_config_fields_match_jax():
    d = load_experiment_model_config("configs/experiment/seqs_multigeo_4cm.yaml")
    ours, ref = config_from_dict(GenNerfConfig, d), j_config_from_dict(JConfig, d)

    def check(o, r, path):
        for f in dataclasses.fields(o):
            ov, rv = getattr(o, f.name), getattr(r, f.name)
            if dataclasses.is_dataclass(ov):
                check(ov, rv, f"{path}.{f.name}")
            else:
                assert ov == rv, f"{path}.{f.name}: {ov} != {rv}"

    check(ours, ref, "cfg")
    assert ours.encoder_latent == 32 and ours.mlp.d_hidden == 256


# ported in float32 (tests/test_torch_options.py) and under bf16-mixed
# (tests/test_torch_options_bf16.py)
BF16_OPTIONS = [
    ({"encoder": {"pointnet": {"plane_type": ["grid"]}}}, "grid"),
    ({"encoder": {"pointnet": {"sparsifier": "voxel_hash"}}}, "voxel_hash"),
    ({"encoder": {"plane_merger": {"strategy": "learn"}}}, "learn"),
    ({"mlp": {"use_spade": True}}, "use_spade"),
    ({"mlp": {"use_layer_norm": True}}, "use_layer_norm"),
    ({"encoder": {"pointnet": {"unet_kwargs": {"merge_mode": "add"}}}}, "add"),
]


def _merge(a, b):
    out = dict(a)
    for k, v in b.items():
        out[k] = _merge(a.get(k, {}), v) if isinstance(v, dict) else v
    return out


@pytest.mark.parametrize("override", [
    {"encoder": {"use_auxiliary": True, "auxiliary_dim": 8}, "teacher": {"type": "maskclip"}},
    {"encoder": {"use_pointnet": False}},
    {"sampling_mode": "grid"},
    {"sampling_mode": "frustum", "loss": {"use_gradient": True}},
    {"loss": {"use_distill": True}, "teacher": {"type": "clip"}},
    {"teacher": {"type": "dino"}},
    {"optimizer": {"type": "SGD"}},
    {"scheduler": {"type": "CosineAnnealingLR"}},
])
def test_unsupported_options_raise(override):
    cfg = config_from_dict(GenNerfConfig, _merge(SMALL_CFG, override))
    with pytest.raises(NotImplementedError):
        check_supported(cfg)
    with pytest.raises(NotImplementedError):
        GenNerf(cfg)


@pytest.mark.parametrize("norm_type,warns", [("sync_batch", False), ("instance", True)])
def test_spatial_norm_type_builds(norm_type, warns):
    """A spatial norm_type other than 'batch' builds: 'sync_batch' is
    'batch' on one card, silently; a value the JAX ResNet ignores computes
    BatchNorm too and warns (tests/test_torch_spatial_options.py holds both
    against JAX)."""
    cfg = config_from_dict(GenNerfConfig, _merge(SMALL_CFG, {"encoder": {
        "use_spatial": True, "spatial": {"norm_type": norm_type}}}))
    check_supported(cfg)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        GenNerf(cfg)
    assert any("norm_type" in str(w.message) for w in caught) == warns


def test_spatial_upsample_interp_builds():
    """A non-bilinear spatial upsample builds; with more than one layer the
    unresized maps cannot be concatenated, a ValueError naming their sizes
    (the JAX concatenate fails there too: tests/test_torch_spatial_options.py)."""
    cfg = config_from_dict(GenNerfConfig, _merge(SMALL_CFG, {"encoder": {
        "use_spatial": True, "spatial": {"upsample_interp": "nearest", "num_layers": 2,
                                         "backbone": "resnet18"}}}))
    check_supported(cfg)
    model = GenNerf(cfg)
    with torch.no_grad(), pytest.raises(ValueError, match="sizes"):
        model.spatial(torch.zeros(1, 3, 32, 32))


@pytest.mark.parametrize("override,name", BF16_OPTIONS, ids=[n for _, n in BF16_OPTIONS])
def test_ported_options_build_under_bf16(override, name):
    """Each option builds in float32 and in bfloat16 (bf16-mixed): its
    layers compute in the model's dtype where flax's do
    (tests/test_torch_options_bf16.py holds them against JAX's bf16)."""
    cfg = config_from_dict(GenNerfConfig, _merge(SMALL_CFG, override))
    check_supported(cfg)
    assert GenNerf(cfg).dtype == torch.float32
    assert GenNerf(cfg, dtype=torch.bfloat16).dtype == torch.bfloat16


def test_bf16_precision_raises():
    """GenNerf computes in float32 or bfloat16 (bf16-mixed; the JAX
    package maps 16-mixed onto bf16 too): float16 raises, bf16 builds."""
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        GenNerf(config_from_dict(GenNerfConfig, SMALL_CFG), dtype=torch.float16)
    assert GenNerf(config_from_dict(GenNerfConfig, SMALL_CFG), dtype=torch.bfloat16).dtype == \
        torch.bfloat16
