"""The spatial encoder's `norm_type` and `upsample_interp` options in both
model families, in the port against the JAX package on the CPU.

The JAX ResNet builds flax's BatchNorm for every norm_type ('sync_batch'
binds an axis name, the same norm on one card; 'instance', 'group' and
'none' are ignored), so each of the five values computes BatchNorm: the
port's encode equals JAX's for each, 'sync_batch' equals 'batch' bit for
bit without a word, and the three ignored values warn once per model.
An `upsample_interp` other than 'bilinear' leaves the maps unresized, as
the JAX encoder does: at one layer the encode equals JAX's; at two layers
the stage map is half the stem's size and the concatenation fails in both
packages (the port raises ValueError naming the sizes, JAX's concatenate
TypeError); with use_first_pool false the two maps share a size and both
concatenate them.

Sizes are small: resnet18 (num_layers 1 and 2) on 2 frames of 32x40, a
16x16x8 volume at 8 cm; GenNerf spatial-only, VoxelNet with channels [8,
16, 32]. Every BatchNorm's scale, bias and running statistics are drawn at
random. JAX runs under default_matmul_precision("highest"), the port with
TF32 off. Tolerance: the feature volumes (eval mode, and GenNerf's in
train mode) within 1e-5 of their largest magnitude (the
tests/test_torch_spatial.py bound), the observation counts exactly.
"""
import copy
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gennerf_tpu.models.gen_nerf import GenNerf as JGenNerf
from gennerf_tpu.train.tasks import GenNerfTask, VoxelNetTask
from gennerf_tpu_torch.data.synthetic import training_batch
from gennerf_tpu_torch.models.config import GenNerfConfig, VoxelNetConfig, config_from_dict
from gennerf_tpu_torch.models.gen_nerf import GenNerf
from gennerf_tpu_torch.models.voxel_net import VoxelNet
from gennerf_tpu_torch.utils.port_params import (
    gen_nerf_params_from_flax, voxel_net_params_from_flax,
)

import _torch_threads  # noqa: F401  (sizes torch's threads per xdist worker)

VD = (16, 16, 8)
VS = 0.08
T, H, W = 2, 32, 40
NORM_TYPES = ["batch", "sync_batch", "instance", "group", "none"]
SPATIAL = {"backbone": "resnet18", "num_layers": 2, "feature_scale": 1.0, "blur_image": False}
GEN_NERF = {
    "type": "GenNerf", "voxel_size": VS, "voxel_dim_train": list(VD), "voxel_dim_val": list(VD),
    "voxel_dim_test": list(VD),
    "encoder": {"use_spatial": True, "spatial": SPATIAL, "use_pointnet": False},
    "mlp": {"d_out_sem": 1, "d_out_geo": 8, "n_blocks": 2, "d_hidden": 32, "alpha": 0.7},
    "code": {"num_freqs": 6, "freq_factor": 0.5, "include_input": True},
    "optimizer": {"type": "Adam", "lr": 0.001, "weight_decay": 0.0},
}
VOXEL_NET = {
    "type": "VoxelNet", "voxel_size": VS, "voxel_dim_train": list(VD), "voxel_dim_val": list(VD),
    "voxel_dim_test": list(VD),
    "encoder": {"use_spatial": True, "use_pointnet": False, "spatial": SPATIAL},
    "backbone3d": {"channels": [8, 16, 32], "layers_down": [1, 2, 3], "layers": [2, 1],
                   "norm": "BN", "conditional_skip": True},
    "heads": {"use_tsdf": True, "tsdf": {"multi_scale": True, "loss_split": "pred"}},
    "optimizer": {"type": "Adam", "lr": 0.001, "weight_decay": 0.0},
}
FAMILIES = {"GenNerf": (GEN_NERF, GenNerfTask), "VoxelNet": (VOXEL_NET, VoxelNetTask)}


def _cfg(family: str, **spatial) -> dict:
    cfg = copy.deepcopy(FAMILIES[family][0])
    cfg["encoder"]["spatial"].update(spatial)
    return cfg


@pytest.fixture(autouse=True)
def _f32_highest():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with jax.default_matmul_precision("highest"):
        yield


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(ours, ref, tol=1e-5):
    ref = np.asarray(ref, np.float32)
    ours = ours.detach().numpy()
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=tol * max(float(np.abs(ref).max()), 1e-30))


@pytest.fixture(scope="module")
def batch():
    return training_batch(1, T, H, W, VD, VS, seed=4)


def _randomize(tree: dict, stats: dict, rng) -> None:
    for k, v in tree.items():
        if not isinstance(v, dict):
            continue
        if "scale" in v:
            v["scale"] = rng.uniform(0.5, 1.5, v["scale"].shape).astype(np.float32)
            v["bias"] = (0.1 * rng.standard_normal(v["bias"].shape)).astype(np.float32)
            if k in stats:
                stats[k]["mean"] = (0.1 * rng.standard_normal(stats[k]["mean"].shape)).astype(
                    np.float32)
                stats[k]["var"] = rng.uniform(0.5, 2.0, stats[k]["var"].shape).astype(np.float32)
        else:
            _randomize(v, stats.get(k, {}), rng)


def _args(batch):
    return tuple(jnp.asarray(batch[k]) for k in ("projection", "image", "depth"))


_CACHE = {}


def variables(family: str, batch, **spatial):
    """Randomized flax variables of the family at these spatial settings
    (the norm_type and upsample_interp add no parameter: one set serves)."""
    key = (family, spatial.get("num_layers", 2), spatial.get("use_first_pool", True))
    if key not in _CACHE:
        cfg = _cfg(family, **spatial, upsample_interp="bilinear", norm_type="batch")
        model = FAMILIES[family][1](cfg).model
        args = _args(batch)
        if family == "GenNerf":
            v = jax.jit(model.init, static_argnums=(6,))(
                jax.random.PRNGKey(0), *args, jnp.zeros((1, 8, 3)), jax.random.PRNGKey(0), VD,
                jnp.zeros(3))
        else:
            v = jax.jit(model.init, static_argnums=(4,))(jax.random.PRNGKey(0), *args, VD,
                                                           jnp.zeros(3))
        params = jax.tree.map(lambda a: np.array(a, np.float32), dict(v["params"]))
        stats = jax.tree.map(lambda a: np.array(a, np.float32), dict(v["batch_stats"]))
        _randomize(params, stats, np.random.default_rng(5))
        _CACHE[key] = params, stats
    return _CACHE[key]


def _jax_volume(family, cfg, batch, params, stats, train=False):
    """The JAX family's encode (volume, valid), op by op."""
    model = FAMILIES[family][1](cfg).model
    v = {"params": params, "batch_stats": stats}
    if family == "GenNerf":
        out = model.apply(v, *_args(batch), jax.random.PRNGKey(1), VD, jnp.zeros(3), train=train,
                          method=JGenNerf.encode, mutable=["batch_stats"])[0]
    else:
        out = model.apply(v, *_args(batch), VD, jnp.zeros(3), train=train,
                          method=model.encode, mutable=["batch_stats"])[0]
    return out.volume, out.valid


def _port_model(family, cfg, params, stats):
    if family == "GenNerf":
        model = GenNerf(config_from_dict(GenNerfConfig, cfg))
        model.load_state_dict(gen_nerf_params_from_flax(params, stats))
    else:
        model = VoxelNet(config_from_dict(VoxelNetConfig, cfg))
        model.load_state_dict(voxel_net_params_from_flax(params, stats))
    return model


def _port_volume(model, batch, train=False):
    model.train(train)
    with torch.no_grad():
        proj, image = _t(batch["projection"]), _t(batch["image"])
        if isinstance(model, GenNerf):
            r = model.encode(proj, image, _t(batch["depth"]), voxel_dim=VD)
        else:
            r = model.encode(proj, image, VD)
    return r.volume, r.valid


# -- norm_type ---------------------------------------------------------------------------

@pytest.mark.parametrize("norm_type", NORM_TYPES)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_norm_type_computes_batch_norm(family, norm_type, batch):
    """Every value builds and encodes as JAX's (BatchNorm); 'batch' and
    'sync_batch' say nothing, the three values JAX ignores warn once."""
    cfg = _cfg(family, norm_type=norm_type)
    params, stats = variables(family, batch)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        model = _port_model(family, cfg, params, stats)
    warned = [w for w in caught if "norm_type" in str(w.message)]
    assert len(warned) == (norm_type not in ("batch", "sync_batch"))
    if warned:
        assert repr(norm_type) in str(warned[0].message)
    vol, valid = _port_volume(model, batch)
    ref_vol, ref_valid = _jax_volume(family, cfg, batch, params, stats)
    _close(vol, ref_vol)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
    if norm_type != "batch":
        same = _port_volume(_port_model(family, _cfg(family, norm_type="batch"), params, stats),
                            batch)
        assert torch.equal(vol, same[0]) and torch.equal(valid, same[1])


@pytest.mark.parametrize("norm_type", ["sync_batch", "instance"])
def test_norm_type_in_training_mode(batch, norm_type):
    """Training mode (batch statistics, the running ones moved): GenNerf's
    volume against JAX's, and bit for bit the 'batch' model's, statistics
    too."""
    cfg = _cfg("GenNerf", norm_type=norm_type)
    params, stats = variables("GenNerf", batch)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = _port_model("GenNerf", cfg, params, stats)
    vol, _ = _port_volume(model, batch, train=True)
    _close(vol, _jax_volume("GenNerf", cfg, batch, params, stats, train=True)[0])
    plain = _port_model("GenNerf", _cfg("GenNerf"), params, stats)
    assert torch.equal(vol, _port_volume(plain, batch, train=True)[0])
    for k, v in plain.state_dict().items():
        assert torch.equal(v, model.state_dict()[k]), k


# -- upsample_interp ------------------------------------------------------------------------

@pytest.mark.parametrize("interp", ["nearest", "bicubic"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_unresized_maps_at_one_layer(family, interp, batch):
    """num_layers 1: the stem alone, no resize in either package."""
    cfg = _cfg(family, num_layers=1, upsample_interp=interp)
    params, stats = variables(family, batch, num_layers=1)
    vol, valid = _port_volume(_port_model(family, cfg, params, stats), batch)
    ref_vol, ref_valid = _jax_volume(family, cfg, batch, params, stats)
    _close(vol, ref_vol)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_unresized_maps_at_two_layers_fail_in_both(family, batch):
    """num_layers 2 with the first pool: the stage map is half the stem's
    size; the port raises ValueError naming both sizes, the JAX
    concatenate raises TypeError."""
    cfg = _cfg(family, upsample_interp="nearest")
    params, stats = variables(family, batch)
    model = _port_model(family, cfg, params, stats)
    with pytest.raises(ValueError, match=r"\(16, 20\), \(8, 10\)"):
        _port_volume(model, batch)
    with pytest.raises(TypeError, match="concatenate"):
        _jax_volume(family, cfg, batch, params, stats)


def test_unresized_maps_of_one_size_concatenate(batch):
    """num_layers 2 without the first pool: the first stage keeps the
    stem's size, so both packages concatenate the unresized maps (and the
    result equals the bilinear model's: a resize to one's own size is the
    identity)."""
    cfg = _cfg("GenNerf", use_first_pool=False, upsample_interp="nearest")
    params, stats = variables("GenNerf", batch, use_first_pool=False)
    vol, _ = _port_volume(_port_model("GenNerf", cfg, params, stats), batch)
    _close(vol, _jax_volume("GenNerf", cfg, batch, params, stats)[0])
    bilinear = _cfg("GenNerf", use_first_pool=False)
    assert torch.equal(vol, _port_volume(_port_model("GenNerf", bilinear, params, stats),
                                         batch)[0])
