"""Weights in and out of the port on the CPU, against the JAX package's own
porters and its orbax checkpoints.

- The reader (utils/port_reference.py, the predict CLI's `--params`) on a
  reference-named Lightning `.ckpt` made by the JAX exporter
  `export_gen_nerf_params` of a JAX GenNerf (pointnet; and spatial, its
  ResNet the JAX package's torchvision-shaped fabrication under
  `encoder.model.`, grafted on the JAX side by `load_pretrained_into_variables`),
  and on a reference-named VoxelNet dict ported on the JAX side by
  `port_backbone3d` / `port_voxel_heads`: the port's outputs equal JAX's.
- The writer against `port_gen_nerf_params`: the JAX model on the port's
  exported weights (SPADE and the learned merger among them; a spatial
  model's ResNet) decodes as the port does.
- The restricted unpickler on a `.ckpt` whose hyper_parameters pickle a
  class of a module that does not exist, and a reduce that would run code.
- Strict reading (a missing port parameter raises with its name and shape),
  `partial` (left at init, printed), unused keys (warned), the format
  dispatch, `--resume` of a reference `.ckpt` (refused) and the
  tools/port_weights.py round trip.
- scripts/orbax_to_npz.py on runs that the test writes with the JAX
  CheckpointManager (GenNerf with SPADE, monitored, best epoch; VoxelNet
  with batch_stats), read back through `--params`.

Sizes are small (2 frames of 12x16 or 24x32, c_dim 8, H 32, 2 blocks;
resnet18 with num_layers 2; VoxelNet channels [8, 16, 32] on a 16x16x8
volume). JAX runs under default_matmul_precision("highest"), the port with
TF32 off. The GenNerf comparisons avoid the encoder's FPS (float32
near-ties that the frameworks may break apart): the decode of JAX's
encoding, the pointnet on one cloud, the spatial volume. Tolerance:
GenNerf outputs within 1e-5 of the reference's largest magnitude
(float32 in another summation order); VoxelNet's eval-mode outputs within
1e-5 relative with that floor (tests/test_torch_voxelnet.py's eval bound:
BatchNorms and 3D convolutions summed in another order), except the
reader's VoxelNet, refereed by float64 (its test's docstring); weights that
only move between files bit for bit.
"""
import copy
import functools
import hashlib
import json
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gennerf_tpu.models.config import GenNerfConfig as JGenNerfConfig
from gennerf_tpu.models.config import config_from_dict as j_config_from_dict
from gennerf_tpu.models.gen_nerf import GenNerf as JGenNerf
from gennerf_tpu.models.gen_nerf import SceneRepr as JRepr
from gennerf_tpu.models.voxel_net import VoxelNet as JVoxelNet
from gennerf_tpu.train.checkpoints import CheckpointManager as JCheckpointManager
from gennerf_tpu.train.state import create_train_state
from gennerf_tpu.train.tasks import GenNerfTask, VoxelNetTask
from gennerf_tpu.utils.port_gen_nerf import (
    export_gen_nerf_params, port_backbone3d, port_gen_nerf_params, port_voxel_heads,
)
from gennerf_tpu.utils.port_torch import load_pretrained_into_variables
from gennerf_tpu_torch.data.synthetic import training_batch
from gennerf_tpu_torch.models.config import (
    GenNerfConfig, VoxelNetConfig, config_from_dict,
)
from gennerf_tpu_torch.models.gen_nerf import GenNerf, SceneRepr
from gennerf_tpu_torch.models.voxel_net import VoxelNet
from gennerf_tpu_torch.predict import build_model, load_params, load_weights
from gennerf_tpu_torch.predict import main as predict_main
from gennerf_tpu_torch.tools.port_weights import main as port_weights_main
from gennerf_tpu_torch.train.__main__ import main as train_main
from gennerf_tpu_torch.utils.config import load_experiment_config, load_experiment_model_config
from gennerf_tpu_torch.utils.port_reference import (
    read_reference_checkpoint, reference_state_dict, weights_format,
)

import _torch_threads  # noqa: F401  (sizes torch's threads per xdist worker)
from _torch_referee import assert_nearer_float64

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import orbax_to_npz  # noqa: E402
from port_weights import fabricate_resnet_state_dict  # noqa: E402

VD = (16, 16, 8)
TOL = 1e-5
POINTNET = {"num_sparse_points": 32, "fps_presample": 64, "normalize_coords": True, "c_dim": 8,
            "hidden_dim": 8, "plane_resolution": 16, "n_blocks": 2, "unet": True,
            "unet_kwargs": {"depth": 2, "merge_mode": "concat", "start_filts": 8}}
GEN_NERF = {
    "type": "GenNerf", "voxel_size": 0.08,
    "voxel_dim_train": list(VD), "voxel_dim_val": list(VD), "voxel_dim_test": list(VD),
    "encoder": {"use_spatial": False, "use_pointnet": True, "pointnet": POINTNET},
    "mlp": {"d_out_sem": 1, "d_out_geo": 8, "n_blocks": 2, "d_hidden": 32, "alpha": 0.7},
    "code": {"num_freqs": 6, "freq_factor": 0.5, "include_input": True},
    "optimizer": {"type": "Adam", "lr": 0.001, "weight_decay": 0.0001},
}
SPATIAL = {**GEN_NERF, "encoder": {
    "use_spatial": True, "use_pointnet": True, "pointnet": POINTNET,
    "spatial": {"backbone": "resnet18", "num_layers": 2, "feature_scale": 1.0,
                "blur_image": False}}}
OPTIONS = {**GEN_NERF, "encoder": {**GEN_NERF["encoder"], "plane_merger": {"strategy": "learn"}},
           "mlp": {**GEN_NERF["mlp"], "use_spade": True}}
VOXEL_NET = {"type": "VoxelNet", "voxel_size": 0.08, "voxel_dim_train": list(VD),
             "voxel_dim_val": list(VD), "voxel_dim_test": list(VD),
             "encoder": {"use_spatial": True, "use_pointnet": False,
                         "spatial": {"backbone": "resnet18", "num_layers": 2,
                                     "feature_scale": 1.0, "blur_image": False}},
             "backbone3d": {"channels": [8, 16, 32], "layers_down": [1, 2, 3], "layers": [2, 1],
                            "norm": "BN", "conditional_skip": True},
             "heads": {"use_tsdf": True, "tsdf": {"multi_scale": True, "loss_split": "pred"}},
             "optimizer": {"type": "Adam", "lr": 0.001, "weight_decay": 0.0}}


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(ours, ref, tol=TOL, rtol=0.0):
    ref = np.asarray(ref, np.float32)
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=rtol,
                               atol=tol * max(float(np.abs(ref).max()), 1e-30))


@pytest.fixture(autouse=True)
def _f32_highest():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with jax.default_matmul_precision("highest"):
        yield


def _frames(H=12, W=16, seed=1):
    return training_batch(1, 2, H, W, VD, 0.08, seed=seed)


def _randomize(tree, rng):
    """Zero-init fc_1 kernels, every norm's scale and bias at random."""
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
    r = m.encode(projection, image, depth, key, voxel_dim, origin)
    return m.decode(m.merge(r, r), xyz, origin)


def _jax_gen_nerf(cfg, b):
    """(JAX task, variables as numpy dicts: params randomized, batch_stats)."""
    task = GenNerfTask(cfg)
    with jax.default_matmul_precision("highest"):
        variables = jax.jit(functools.partial(task.model.init, method=_init_all),
                            static_argnums=(6,))(
            jax.random.PRNGKey(0), *(jnp.asarray(b[k]) for k in ("projection", "image", "depth")),
            jnp.zeros((1, 8, 3)), jax.random.PRNGKey(1), VD, jnp.zeros(3))
    variables = jax.tree.map(lambda a: np.array(a, np.float32), dict(variables))
    _randomize(variables["params"], np.random.default_rng(7))
    return task, {"params": variables["params"],
                  "batch_stats": variables.get("batch_stats", {})}


def _fabricated_resnet(seed=3):
    """The JAX package's torchvision-shaped resnet18 with its BatchNorm
    parameters and statistics drawn at random."""
    rng = np.random.default_rng(seed)
    sd = fabricate_resnet_state_dict("resnet18", seed)
    for k in sd:
        if k.endswith(("bn1.weight", "bn2.weight", "downsample.1.weight")):
            sd[k] = rng.uniform(0.5, 1.5, sd[k].shape).astype(np.float32)
        elif k.endswith("running_var"):
            sd[k] = rng.uniform(0.5, 2.0, sd[k].shape).astype(np.float32)
        elif k.endswith(("running_mean", ".bias")):
            sd[k] = (0.1 * rng.standard_normal(sd[k].shape)).astype(np.float32)
    return sd


def _hold_against_jax(task, variables, model, b, key, seed=2):
    """The port against the JAX model on the same weights, where no draw
    decides: the decode of JAX's encoding at points over and past the
    volume, the pointnet on one cloud, and the spatial feature volume of
    the port's own encode (FPS picks are float32 near-ties that the two
    frameworks may break apart; they feed none of these)."""
    jm = task.model
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-0.1, 1.4, (1, 200, 3)).astype(np.float32)
    cloud = rng.uniform(-0.55, 0.55, (1, 64, 3)).astype(np.float32)
    args = tuple(jnp.asarray(b[k]) for k in ("projection", "image", "depth"))
    with jax.default_matmul_precision("highest"):
        r = jax.jit(functools.partial(jm.apply, method=JGenNerf.encode), static_argnums=(5,))(
            variables, *args, key, VD, jnp.zeros(3))
        out_j = jax.jit(functools.partial(jm.apply, method=JGenNerf.decode))(
            variables, r, jnp.asarray(xyz), jnp.zeros(3))
        planes_j = jm.apply(variables, jnp.asarray(cloud), method=lambda m, p: m.pointnet(p))
    model.eval()
    with torch.no_grad():
        repr_ = SceneRepr({k: _t(v) for k, v in r.planes.items()},
                          None if r.volume is None else _t(r.volume),
                          None if r.valid is None else _t(r.valid))
        out = model.decode(repr_, _t(xyz))
        planes = model.pointnet(_t(cloud))
        for k in ("feat", "feat_geo", "feat_sem", "tsdf"):
            _close(out[k], out_j[k])
        for k in planes_j:
            _close(planes[k], planes_j[k])
        if r.volume is not None:
            own = model.encode(*(_t(b[k]) for k in ("projection", "image", "depth")),
                               generator=torch.Generator().manual_seed(0), voxel_dim=VD)
            _close(own.volume, r.volume)
            _close(own.valid, r.valid, tol=0)
    return out, out_j


def _save_ckpt(path, state_dict, hyper_parameters=None):
    obj = {"state_dict": {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
                          for k, v in state_dict.items()}, "epoch": 7, "global_step": 70}
    if hyper_parameters is not None:
        obj["hyper_parameters"] = hyper_parameters
    torch.save(obj, path)


class _ForeignModule:
    """Makes `omegaconf_absent.dictconfig.DictConfig` importable while a
    checkpoint is written, and not afterwards."""

    def __enter__(self):
        mod = types.ModuleType("omegaconf_absent.dictconfig")

        class DictConfig(dict):
            pass

        DictConfig.__module__, DictConfig.__qualname__ = mod.__name__, "DictConfig"
        mod.DictConfig = DictConfig
        sys.modules["omegaconf_absent"] = types.ModuleType("omegaconf_absent")
        sys.modules[mod.__name__] = mod
        return DictConfig

    def __exit__(self, *exc):
        del sys.modules["omegaconf_absent"], sys.modules["omegaconf_absent.dictconfig"]


# -- the reader -------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [GEN_NERF, SPATIAL], ids=["pointnet", "spatial"])
def test_reader_against_jax_exporter(cfg, tmp_path):
    """A JAX GenNerf exported by export_gen_nerf_params (and, spatial, the
    fabricated ResNet under encoder.model., grafted into the JAX model by
    load_pretrained_into_variables) read through `--params`: the port's
    encode and decode equal JAX's."""
    b = _frames(24, 32) if cfg is SPATIAL else _frames()
    task, variables = _jax_gen_nerf(cfg, b)
    reference = export_gen_nerf_params(variables["params"], task.cfg)
    if cfg is SPATIAL:
        resnet = _fabricated_resnet()
        variables = load_pretrained_into_variables(variables, resnet, "resnet18", 1)
        reference.update({"encoder.model." + k: v for k, v in resnet.items()})
    path = str(tmp_path / "last.ckpt")
    with _ForeignModule() as foreign:
        _save_ckpt(path, reference, foreign({"model": {"mlp": {"alpha": 0.7}}}))
    model = GenNerf(config_from_dict(GenNerfConfig, cfg))
    with pytest.warns(UserWarning) if cfg is SPATIAL else _no_warning():
        loaded = load_params(model, path)
    assert loaded == {"format": "reference", "unfilled": []}
    _hold_against_jax(task, variables, model, b, jax.random.PRNGKey(3))


class _no_warning:
    def __enter__(self):
        import warnings
        self._ctx = warnings.catch_warnings()
        self._ctx.__enter__()
        warnings.simplefilter("error")

    def __exit__(self, *exc):
        self._ctx.__exit__(*exc)


def test_reader_voxel_net_against_jax_porters(tmp_path):
    """A reference-named VoxelNet dict (torchvision ResNet under
    encoder.model., backbone3d.*, heads3d.heads.0.decoders.{i}, values at
    random) through port_backbone3d / port_voxel_heads / port_resnet on the
    JAX side and the reader (partial: the 2D spatial.proj, whose reference
    name is not documented, stays at the port's init and is copied into the
    JAX model) on the port's: eval-mode outputs equal (He-init
    convolutions, BatchNorm parameters and statistics at random).

    Refereed by the port's VoxelNet in float64 on the same weights and
    inputs: the JAX model in float64 (x64) within TOL of its max-abs (the
    reader maps every weight as the porters do; both packages accumulate
    the backprojected volume in float32, which leaves ~1e-6), and the
    port's float32 output at most _torch_referee.FACTOR times as far from it
    as JAX's float32 output. Through ~20 convolutions the two float32
    outputs each lie 1e-6 to 2e-5 of max-abs from float64, so a bound of
    1e-5 between them fired by chance."""
    b = _frames(24, 32)
    rng = np.random.default_rng(4)
    model = VoxelNet(config_from_dict(VoxelNetConfig, VOXEL_NET))
    reference = {"encoder.model." + k: v for k, v in _fabricated_resnet().items()}
    for k, v in model.state_dict().items():
        if k.startswith(("backbone3d.", "heads3d.")):
            if k.endswith("running_var") or (k.endswith(".weight") and v.dim() == 1):
                reference[k] = rng.uniform(0.5, 1.5, tuple(v.shape)).astype(np.float32)
            elif v.dim() > 1:  # He-init convolutions
                std = np.sqrt(2.0 / v[0].numel())
                reference[k] = (std * rng.standard_normal(tuple(v.shape))).astype(np.float32)
            else:
                reference[k] = (0.1 * rng.standard_normal(tuple(v.shape))).astype(np.float32)
    path = str(tmp_path / "voxel_net.pth")
    torch.save({k: torch.from_numpy(v) for k, v in reference.items()}, path)
    with pytest.raises(KeyError, match=r"spatial\.proj\.weight \(8, 128, 1, 1\)"):
        load_params(model, path)
    with pytest.warns(UserWarning, match="no port parameter takes"):
        loaded = load_params(model, path, partial=True)
    assert loaded["unfilled"] == ["spatial.proj.weight", "spatial.proj.bias"]

    task = VoxelNetTask(VOXEL_NET)
    args = tuple(jnp.asarray(b[k]) for k in ("projection", "image", "depth"))
    with jax.default_matmul_precision("highest"):
        variables = jax.jit(task.model.init, static_argnums=(4, 6))(
            jax.random.PRNGKey(0), *args, VD, jnp.zeros(3), None)
    variables = jax.tree.map(lambda a: np.array(a, np.float32), dict(variables))
    bp, bs = port_backbone3d(reference, (1, 2, 3), (2, 1))
    variables["params"]["backbone3d"], variables["batch_stats"]["backbone3d"] = bp, bs
    variables["params"]["heads3d"] = port_voxel_heads(reference, 2)
    variables = load_pretrained_into_variables(
        variables, {k[len("encoder.model."):]: v for k, v in reference.items()
                    if k.startswith("encoder.model.")}, "resnet18", 1)
    variables["params"]["spatial"]["proj"] = {
        "kernel": model.spatial.proj.weight.detach().numpy().transpose(2, 3, 1, 0),
        "bias": model.spatial.proj.bias.detach().numpy()}
    with jax.default_matmul_precision("highest"):
        (ref, _), _ = task.model.apply(variables, *args, VD, jnp.zeros(3), None, train=False,
                                       mutable=["batch_stats"])
    model.eval()
    m64 = copy.deepcopy(model).double()
    with torch.no_grad():
        ours, _ = model(_t(b["projection"]), _t(b["image"]), VD)
        out64, _ = m64(_t(b["projection"]), _t(b["image"]).double(), VD)
    with jax.enable_x64(True):
        (ref64, _), _ = JVoxelNet(task.cfg, dtype=jnp.float64).apply(
            jax.tree.map(lambda a: np.asarray(a, np.float64), variables),
            *(a.astype(jnp.float64) for a in args), VD, jnp.zeros(3), None, train=False,
            mutable=["batch_stats"])
    assert set(ours) == set(ref) == set(ref64)
    for k in ref:
        _close(np.asarray(ref64[k]), out64[k].numpy())
        assert_nearer_float64(ours[k], ref[k], out64[k], k)


# -- the writer -------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", [OPTIONS, SPATIAL], ids=["spade_learn", "spatial"])
def test_writer_against_jax_porter(cfg):
    """The port's weights (random, fc_1 non-zero) through the writer and
    port_gen_nerf_params (+ the JAX ResNet graft): the JAX model encodes,
    merges and decodes as the port does."""
    b = _frames(24, 32) if cfg is SPATIAL else _frames()
    torch.manual_seed(0)
    model = GenNerf(config_from_dict(GenNerfConfig, cfg))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".fc_1." in name or "running" in name:
                p.copy_(0.1 * torch.randn(p.shape))
    reference = {k: v.numpy() for k, v in reference_state_dict(model).items()}
    assert "mlp.alpha" not in reference  # equal to the config's: the reference has none
    task = GenNerfTask(cfg)
    jcfg = j_config_from_dict(JGenNerfConfig, cfg)
    _, init = _jax_gen_nerf(cfg, b)
    params = dict(init["params"], **port_gen_nerf_params(reference, jcfg))
    variables = {"params": params, "batch_stats": init["batch_stats"]}
    if cfg is SPATIAL:
        variables = load_pretrained_into_variables(
            variables, {k[len("encoder.model."):]: v for k, v in reference.items()
                        if k.startswith("encoder.model.")}, "resnet18", 1)
    else:
        assert "scale_z_0" in params["mlp"] and "merge_conv" in params["merger"]
    _hold_against_jax(task, variables, model, b, jax.random.PRNGKey(6), seed=5)
    if cfg is OPTIONS:
        rng = np.random.default_rng(8)
        a, c = ({k: rng.standard_normal((1, 8, 16, 16)).astype(np.float32)
                 for k in ("xz", "xy", "yz")} for _ in range(2))
        merged_j = task.model.apply(variables, JRepr(None, None, a), JRepr(None, None, c),
                                    method=JGenNerf.merge)
        merged = model.merge(SceneRepr({k: _t(v) for k, v in a.items()}),
                             SceneRepr({k: _t(v) for k, v in c.items()}))
        for k in a:
            _close(merged.planes[k], merged_j.planes[k])


# -- the file, strictness, entry points -------------------------------------------------

def test_restricted_unpickler(tmp_path):
    """A Lightning-like .ckpt: its hyper_parameters pickle a class whose
    module is gone, and one entry's reduce would run code. The reader
    returns the state dict and plain hyper_parameters, and runs nothing."""
    os.environ.pop("GENNERF_RESTRICTED_UNPICKLER_RAN", None)

    class Runs:
        def __reduce__(self):
            return (exec, ("import os; os.environ['GENNERF_RESTRICTED_UNPICKLER_RAN'] = '1'",))

    path = str(tmp_path / "foreign.ckpt")
    with _ForeignModule() as foreign:
        torch.save({"state_dict": {"mlp.lin_in.weight": torch.arange(6.0).reshape(2, 3)},
                    "hyper_parameters": foreign({"mlp": {"alpha": 0.5}}),
                    "callbacks": {"x": Runs()}, "epoch": 3}, path)
    with pytest.raises(Exception):
        torch.load(path, weights_only=True)  # what a plain safe load does
    ckpt = read_reference_checkpoint(path)
    assert "GENNERF_RESTRICTED_UNPICKLER_RAN" not in os.environ
    assert torch.equal(ckpt.state_dict["mlp.lin_in.weight"], torch.arange(6.0).reshape(2, 3))
    assert ckpt.hyper_parameters["__class__"] == "omegaconf_absent.dictconfig.DictConfig"
    assert ckpt.hyper_parameters["items"] == {"mlp": {"alpha": 0.5}}


def test_strict_partial_and_unused(tmp_path, capsys):
    """A JAX GenNerf with LayerNorm exported by export_gen_nerf_params (which
    writes no LayerNorm) plus a head_sem: strict reading raises naming each
    LayerNorm parameter and its shape; partial leaves them at init and
    prints them; head_sem is warned about."""
    cfg = {**GEN_NERF, "mlp": {**GEN_NERF["mlp"], "use_layer_norm": True}}
    b = _frames()
    task, variables = _jax_gen_nerf(cfg, b)
    reference = export_gen_nerf_params(variables["params"], task.cfg)
    reference["head_sem.fc.weight"] = np.zeros((4, 1), np.float32)
    path = str(tmp_path / "ln.pth")
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in reference.items()}, path)
    model = GenNerf(config_from_dict(GenNerfConfig, cfg))
    with pytest.raises(KeyError, match=r"mlp\.ln\.0\.weight \(32,\).*mlp\.ln\.1\.bias \(32,\)"):
        load_params(model, path)
    init_ln = model.mlp.ln[0].weight.detach().clone()
    with pytest.warns(UserWarning, match="head_sem.fc.weight"):
        loaded = load_params(model, path, partial=True)
    assert loaded["unfilled"] == [f"mlp.ln.{i}.{p}" for i in range(2) for p in ("weight", "bias")]
    assert "left at init (4): mlp.ln.0.weight" in capsys.readouterr().out
    assert torch.equal(model.mlp.ln[0].weight, init_ln)
    _close(model.mlp.lin_in.weight, reference["mlp.lin_in.weight"], tol=0)


def test_formats_and_resume(tmp_path):
    """An unknown format raises; the predict CLI reads a .pth through
    --params; --resume of a reference .ckpt is refused."""
    bogus = tmp_path / "weights.bin"
    bogus.write_bytes(b"not a checkpoint")
    with pytest.raises(ValueError, match="not a params npz"):
        weights_format(str(bogus))
    model = GenNerf(config_from_dict(GenNerfConfig, GEN_NERF))
    with pytest.raises(ValueError):
        load_params(model, str(bogus))
    ref = tmp_path / "ref.ckpt"
    torch.save({"state_dict": reference_state_dict(model), "optimizer_states": [{}]}, str(ref))
    frames = tmp_path / "f.npz"
    b = _frames()
    np.savez(frames, projection=b["projection"][0], image=b["image"][0], depth=b["depth"][0])
    exp = os.path.join(REPO, "configs", "experiment", "overfit_synthetic.yaml")
    tiny = ["model.encoder.pointnet.c_dim=8", "model.encoder.pointnet.hidden_dim=8",
            "model.encoder.pointnet.plane_resolution=16", "model.encoder.pointnet.n_blocks=2",
            "model.encoder.pointnet.num_sparse_points=32",
            "model.encoder.pointnet.fps_presample=64",
            "model.encoder.pointnet.unet_kwargs.depth=2",
            "model.encoder.pointnet.unet_kwargs.start_filts=8", "model.mlp.d_hidden=32",
            "model.mlp.n_blocks=2", "model.mlp.d_out_geo=8", "model.mlp.d_out_sem=1",
            "model.voxel_dim_test=[16,16,8]", "model.voxel_size=0.08"]
    # a raw state dict of the experiment's model, as a reference .pth
    pth = str(tmp_path / "state.pth")
    cfg = load_experiment_config(exp, "predict", tiny)
    torch.save(reference_state_dict(build_model(cfg["model"], "cpu", seed=5)), pth)
    predict_main(["--config", exp, "--params", pth, "--frames", str(frames),
                  "--out", str(tmp_path / "o.npz"), "--device", "cpu", *tiny])
    with np.load(tmp_path / "o.npz") as f:
        assert f["tsdf"].shape == (16, 16, 8) and np.isfinite(f["tsdf"]).all()
    with pytest.raises(NotImplementedError, match="reference Lightning checkpoint"):
        train_main(["--config", exp, "--out", str(tmp_path / "run"), "--synthetic",
                    "--device", "cpu", "--resume", str(ref), *tiny])


def test_port_weights_tool(tmp_path):
    """reference .ckpt -> params npz -> reference .ckpt, and -> port .pt ->
    reference .pth: the same tensors, bit for bit; the .pt serves --ckpt."""
    exp = os.path.join(REPO, "configs", "experiment", "seqs_multigeo_4cm.yaml")
    model = build_model(load_experiment_model_config(exp), "cpu", seed=3)
    src = str(tmp_path / "src.ckpt")
    torch.save({"state_dict": reference_state_dict(model)}, src)
    for middle, out in (("p.npz", "back.ckpt"), ("p.pt", "back.pth")):
        port_weights_main(["gen_nerf", src, str(tmp_path / middle), "--config", exp])
        port_weights_main(["gen_nerf", str(tmp_path / middle), str(tmp_path / out),
                           "--config", exp])
        a = read_reference_checkpoint(src).state_dict
        back = read_reference_checkpoint(str(tmp_path / out)).state_dict
        assert set(a) == set(back) and all(torch.equal(a[k], back[k]) for k in a)
    fresh = build_model(load_experiment_model_config(exp), "cpu", seed=4)
    load_weights(fresh, ckpt=str(tmp_path / "p.pt"))
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    with pytest.raises(SystemExit, match="VoxelNet config"):
        port_weights_main(["voxel_net", src, str(tmp_path / "x.npz"), "--config", exp])


# -- orbax runs ---------------------------------------------------------------------------

def _tree_digest(directory):
    h = hashlib.sha256()
    for root, dirs, files in sorted(os.walk(directory)):
        dirs.sort()
        for name in sorted(files):
            path = os.path.join(root, name)
            h.update(path.encode())
            with open(path, "rb") as f:
                h.update(f.read())
    return h.hexdigest()


def test_orbax_converter_gen_nerf(tmp_path):
    """A monitored JAX run of a SPADE GenNerf, two epochs written by the JAX
    CheckpointManager (epoch 0 the better val_combined): the converter picks
    epoch 0, leaves the run as it was, and its npz read through --params
    decodes as the JAX model on epoch 0's params."""
    cfg = {**GEN_NERF, "mlp": {**GEN_NERF["mlp"], "use_spade": True}}
    b = _frames()
    task, variables = _jax_gen_nerf(cfg, b)
    run = tmp_path / "run"
    ckpt_cfg = {"monitor": "val_combined", "mode": "min", "save_top_k": 2}
    mgr = JCheckpointManager(str(run / "checkpoints"), **ckpt_cfg)
    epochs = []
    for epoch, val in ((0, 0.5), (1, 0.9)):
        params = jax.tree.map(lambda a, e=epoch: a + np.float32(0.01 * e), variables["params"])
        epochs.append(params)
        state = create_train_state({"params": jax.tree.map(jnp.asarray, params)}, task.tx)
        mgr.save(epoch, state, config={"model": cfg, "callbacks": {"model_checkpoint": ckpt_cfg}},
                 metrics={"val_combined": val})
    mgr.close()
    before = _tree_digest(run)
    out = tmp_path / "converted" / "params.npz"
    record = orbax_to_npz.main([str(run), str(out)])
    assert record["epoch"] == 0 and record["selected_by"] == "val_combined"
    assert _tree_digest(run) == before
    assert json.load(open(tmp_path / "converted" / "config.json"))["model"]["mlp"]["use_spade"]
    with np.load(out) as f:
        assert "mlp/scale_z_0/kernel" in f.files and not any(k.startswith("opt_state")
                                                             for k in f.files)
    model = GenNerf(config_from_dict(GenNerfConfig, cfg))
    assert load_params(model, str(out))["format"] == "npz"
    _hold_against_jax(task, {"params": epochs[0]}, model, b, jax.random.PRNGKey(8), seed=7)
    assert orbax_to_npz.main([str(run / "checkpoints"), str(out), "--epoch", "1"])["epoch"] == 1


def test_orbax_converter_voxel_net(tmp_path):
    """A VoxelNet run with batch_stats (unmonitored: the latest epoch) read
    back through --params: the running statistics arrive, the eval forward
    equals JAX's."""
    b = _frames(24, 32)
    task = VoxelNetTask(VOXEL_NET)
    args = tuple(jnp.asarray(b[k]) for k in ("projection", "image", "depth"))
    with jax.default_matmul_precision("highest"):
        variables = jax.jit(task.model.init, static_argnums=(4, 6))(
            jax.random.PRNGKey(0), *args, VD, jnp.zeros(3), None)
    variables = jax.tree.map(lambda a: np.array(a, np.float32), dict(variables))
    _randomize(variables["params"], np.random.default_rng(9))
    rng = np.random.default_rng(10)
    variables["batch_stats"] = jax.tree.map(
        lambda a: rng.uniform(0.5, 1.5, a.shape).astype(np.float32), variables["batch_stats"])
    mgr = JCheckpointManager(str(tmp_path / "run"))
    mgr.save(0, create_train_state(jax.tree.map(jnp.asarray, variables), task.tx),
             config={"model": VOXEL_NET})
    mgr.close()
    out = str(tmp_path / "vn.npz")
    record = orbax_to_npz.main([str(tmp_path / "run"), out])
    assert record["selected_by"] == "latest" and record["batch_stats"] > 0
    model = VoxelNet(config_from_dict(VoxelNetConfig, VOXEL_NET))
    load_params(model, out)
    _close(model.backbone3d.layers_down[0][0].bn1.running_var,
           variables["batch_stats"]["backbone3d"]["down0_b0"]["bn1"]["BatchNorm_0"]["var"], tol=0)
    with jax.default_matmul_precision("highest"):
        (ref, _), _ = task.model.apply(variables, *args, VD, jnp.zeros(3), None, train=False,
                                       mutable=["batch_stats"])
    model.eval()
    with torch.no_grad():
        ours, _ = model(_t(b["projection"]), _t(b["image"]), VD)
    for k in ref:
        _close(ours[k], ref[k], rtol=TOL)
