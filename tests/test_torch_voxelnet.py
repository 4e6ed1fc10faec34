"""The port's VoxelNet and its bf16-mixed precision on the CPU against the
JAX package: the trilinear and nearest 2x upsamples, the 3D
encoder-decoder (train and eval mode, masked skips on and off, remat on
and off: outputs and new running statistics), the multi-scale TSDF heads
(outputs and losses: multi-scale on and off, loss_split 'pred' and 'none',
a missing scale, a target column all +1), a train-mode forward, its losses
and every gradient against `jax.value_and_grad`, two Adam steps against
`make_voxel_net_train_step`, `reconstruct` against
VoxelNetTask.reconstruct (fusion prior on and off), the flax <-> port
params and batch_stats round trip through the npz; under bf16-mixed every
submodule's output dtype against flax's, the outputs' distance to JAX's
bf16 outputs, and a step leaving every parameter and running statistic
float32; `dtype_for_precision`, the config gate, the render CLI refusing a
VoxelNet, and the train -> predict -> evaluation CLIs on a tiny dataset.

Sizes are small: resnet18 with num_layers 2 on 2 frames of 32x32, a
16x16x8 volume at 8 cm, channels [8, 16, 32], layers_down [1, 2, 3],
layers [2, 1], heads at 16 and 8 cm. JAX runs under
default_matmul_precision("highest"), the port with TF32 off. Every
BatchNorm scale, bias and running statistic is drawn at random (the
zero-init bn2 scales too), so every block and norm does work.

Tolerances, float32:
- the upsamples: trilinear within 1e-6 absolute (values of order 1,
  weights 1/4 and 3/4 summed in another order), nearest exactly;
- eval mode (encoder-decoder, heads, VoxelNet outputs, losses,
  reconstruct): within 1e-5 relative with a floor of 1e-5 of the tensor's
  largest magnitude; the heads within 1e-6 absolute (one 1x1x1
  convolution, tanh, the loss sums);
- train mode: new running statistics within 1e-5 relative (floor 1e-5 of
  max-abs), losses within 1e-5 relative; outputs refereed by a float64
  evaluation of the same network (tests/_torch_referee.py): JAX in
  float64 within 1e-5 relative with a floor of 3e-5 of its max-abs, the
  port's float32 no farther from it than JAX's float32 and within 3e-5 of
  its max-abs.
  Train-mode BatchNorm of the JAX package takes the variance as E[x^2] -
  E[x]^2 in float32, which on the normalized volume's channels (mean^2
  much larger than the variance) loses digits: with the randomized
  BatchNorms JAX's outputs lie 2.0e-5 to 2.4e-5 of max-abs from float64,
  the port's 1.2e-5 to 1.8e-5 (1 or 8 threads);
- gradients within 1e-4 of their tensor's largest magnitude (the
  test_torch_train bound: the same float32 differences carried back
  through every BatchNorm's batch statistics);
- two Adam steps (loss_split 'none', see the test): the first step's
  metrics within 1e-5 relative, the second's within 1e-4 (the
  test_torch_train bound); parameters within 1e-2 * lr of JAX's for all
  but 0.1% of the elements and within 0.25 * lr for every one: Adam's
  update m / (sqrt(v) + 1e-8) carries a gradient's float32 difference at
  full size where the gradient nearly vanishes (one ResNet weight ends
  0.11 * lr apart, every other within 2e-4 * lr); running statistics
  within 1e-4 relative (floor 1e-4 of max-abs: the second step's
  statistics see the first step's parameters);
- remat against no remat in the port: outputs and statistics equal, to
  1e-6 relative on the gradients.
bf16-mixed: every output volume at most half as far from JAX's bf16
output as JAX's bf16 output is from JAX's float32 output, the distance
being the mean absolute difference over the volume, and within 1e-4 (eval)
or 1e-2 (train) of it. Both frameworks accumulate each bf16 convolution in
float32 and round once, and under bf16 the port's BatchNorm takes flax's
own expressions, so most values agree bit for bit; what differs is the
float32 rounding of the norms (reduction order, rsqrt), which flips a bf16
rounding now and then, and each flip spreads through the later layers. In
eval mode the distance is 0.05-0.07 of JAX's bf16-to-float32 distance; in
train mode 0.2-0.3, where the batch variance E[x^2] - E[x]^2 cancels
digits on the volume's channels. The largest difference is not a
distance here: one flipped voxel can reach it, and a voxel on either side
of the sparse threshold differs by up to 2 between JAX's own bf16 and
float32 outputs.
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

from gennerf_tpu.models.backbone3d import EncoderDecoder as JEncoderDecoder
from gennerf_tpu.models.backbone3d import _trilinear_up2x as j_up2x
from gennerf_tpu.models.heads import VoxelHeads as JVoxelHeads
from gennerf_tpu.models.heads import _upsample2x_nearest3d as j_nearest
from gennerf_tpu.models.voxel_net import VoxelNet as JVoxelNet
from gennerf_tpu.train.tasks import VoxelNetTask
from gennerf_tpu.train.tasks import dtype_for_precision as j_dtype_for_precision
from gennerf_tpu_torch.data.synthetic import generate_scene, random_primitives, training_batch
from gennerf_tpu_torch.eval.evaluation import main as evaluation_main
from gennerf_tpu_torch.models.backbone3d import EncoderDecoder, trilinear_up2x
from gennerf_tpu_torch.models.config import (
    VoxelNetConfig, check_supported_voxel_net, config_from_dict,
)
from gennerf_tpu_torch.models.heads import VoxelHeads, upsample2x_nearest3d
from gennerf_tpu_torch.models.voxel_net import VoxelNet
from gennerf_tpu_torch.predict import main as predict_main
from gennerf_tpu_torch.predict import build_model, reconstruct
from gennerf_tpu_torch.render import main as render_main
from gennerf_tpu_torch.train.__main__ import main as train_main
from gennerf_tpu_torch.train.state import make_optimizer
from gennerf_tpu_torch.train.step import batch_to_device, train_step, voxel_net_forward_loss
from gennerf_tpu_torch.train.tasks import dtype_for_precision
from gennerf_tpu_torch.utils.config import load_experiment_model_config
from gennerf_tpu_torch.utils.port_params import (
    flax_variables_from_voxel_net, load_params_npz, save_params_npz, voxel_net_npz_tree,
    voxel_net_params_from_flax,
)

import _torch_threads  # noqa: F401  (sizes torch's threads per xdist worker)
from _torch_referee import assert_nearer_float64

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VD = (16, 16, 8)
VS = 0.08
CHANNELS = [8, 16, 32]
CFG = {"type": "VoxelNet", "voxel_size": VS, "voxel_dim_train": list(VD),
       "voxel_dim_val": list(VD), "voxel_dim_test": list(VD),
       "encoder": {"use_spatial": True, "use_pointnet": False,
                   "spatial": {"backbone": "resnet18", "num_layers": 2, "feature_scale": 1.0,
                               "blur_image": False}},
       "backbone3d": {"channels": CHANNELS, "layers_down": [1, 2, 3], "layers": [2, 1],
                      "norm": "BN", "conditional_skip": True},
       "heads": {"use_tsdf": True, "tsdf": {"multi_scale": True, "loss_split": "pred"}},
       "optimizer": {"type": "Adam", "lr": 0.001, "weight_decay": 0.0}}
KEYS = ("vol_08_tsdf", "vol_16_tsdf")


@pytest.fixture(autouse=True)
def _f32_highest():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with jax.default_matmul_precision("highest"):
        yield


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(ours, ref, rtol=1e-5, floor=None):
    ref = np.asarray(ref, np.float32)
    ours = ours.detach().float().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    assert ours.shape == ref.shape
    floor = rtol if floor is None else floor
    np.testing.assert_allclose(ours, ref, rtol=rtol,
                               atol=floor * max(float(np.abs(ref).max()), 1e-30))


def _randomize(params: dict, stats: dict, seed: int):
    """numpy copies of flax variables with every BatchNorm's scale, bias and
    running statistics drawn at random."""
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
            else:
                walk(v, s.get(k, {}))

    walk(params, stats)
    return params, stats


def _batch(seed=3):
    """2 frames of 32x32 with the ground truth at 8 cm, a 16 cm target with
    a column of the finest scale all +1 (the outside mask) beside it."""
    b = training_batch(1, 2, 32, 32, VD, VS, seed=seed)
    b["vol_08_tsdf"][0, 0, 3, 4, :] = 1.0
    rng = np.random.default_rng(seed)
    b["vol_16_tsdf"] = np.clip(rng.uniform(-1.3, 1.3, (1, 1, 8, 8, 4)), -1, 1).astype(np.float32)
    b["vol_16_tsdf"][0, 0, 1, 2, :] = 1.0
    return b


def _jargs(b, targets=True):
    return (jnp.asarray(b["projection"]), jnp.asarray(b["image"]), jnp.asarray(b["depth"]), VD,
            jnp.zeros(3), {k: jnp.asarray(b[k]) for k in KEYS} if targets else None)


def _port(params, stats, cfg=CFG, dtype=torch.float32) -> VoxelNet:
    model = VoxelNet(config_from_dict(VoxelNetConfig, cfg), dtype=dtype)
    model.load_state_dict(voxel_net_params_from_flax(params, stats))
    return model


@pytest.fixture(scope="module")
def pair():
    """(JAX task, randomized params, stats, batch); `_port` builds the port's
    model with the same weights."""
    with jax.default_matmul_precision("highest"):
        task = VoxelNetTask(CFG)
        b = _batch()
        variables = task.model.init(jax.random.PRNGKey(0), *_jargs(b, False)[:3], VD,
                                    jnp.zeros(3), None, train=False)
    params, stats = _randomize(dict(variables["params"]), dict(variables["batch_stats"]), 5)
    return task, params, stats, b


@pytest.fixture(scope="module")
def jax_forward(pair):
    task, params, stats, b = pair
    variables = {"params": params, "batch_stats": stats}

    def run(train: bool, dtype=jnp.float32):
        model = task.model if dtype == jnp.float32 else VoxelNetTask(CFG, "bf16-mixed").model

        def apply(v, *a):
            return model.apply(v, *a[:3], VD, a[3], a[4], train=train, mutable=["batch_stats"])

        args = _jargs(b)
        with jax.default_matmul_precision("highest"):
            # op by op: one call each, cheaper than compiling it (and the
            # bf16 comparison needs it, see the docstring)
            (out, losses), mutated = apply(variables, *args[:3], args[4], args[5])
        return ({k: np.asarray(v, np.float32) for k, v in out.items()},
                {k: float(v) for k, v in losses.items()}, mutated["batch_stats"])

    cache = {}

    def get(train: bool, dtype=jnp.float32):
        if (train, dtype) not in cache:
            cache[train, dtype] = run(train, dtype)
        return cache[train, dtype]

    return get


def _port_forward(model, b, train: bool):
    model.train(train)
    with torch.no_grad():
        return model(_t(b["projection"]), _t(b["image"]), VD, None, {k: _t(b[k]) for k in KEYS})


# -- precision surface, config gate ----------------------------------------------

@pytest.mark.parametrize("precision,expect", [
    (None, torch.float32), ("32-true", torch.float32), (32, torch.float32),
    ("bf16-mixed", torch.bfloat16), ("16-mixed", torch.bfloat16)])
def test_dtype_for_precision(precision, expect):
    """The cases of tests/test_precision.py, against the JAX mapping too."""
    assert dtype_for_precision(precision) == expect
    assert (j_dtype_for_precision(precision) == jnp.bfloat16) == (expect == torch.bfloat16)


def test_dtype_for_precision_rejects():
    with pytest.raises(ValueError):
        dtype_for_precision("fp8")


def _override(override):
    cfg = {**CFG, **{k: {**CFG.get(k, {}), **v} for k, v in override.items()}}
    if "spatial" in override.get("encoder", {}):
        cfg["encoder"] = {**CFG["encoder"], "spatial": {**CFG["encoder"]["spatial"],
                                                        **override["encoder"]["spatial"]}}
    return config_from_dict(VoxelNetConfig, cfg)


@pytest.mark.parametrize("override", [
    {"heads": {"use_tsdf": False}}, {"backbone3d": {"norm": "LN"}}])
def test_unported_voxel_net_options_raise(override):
    """Options the JAX VoxelNet cannot train either: no TSDF head (no loss;
    tests/test_torch_voxelnet_options.py shows the JAX step fail), a norm
    name its _Norm3d refuses."""
    with pytest.raises(NotImplementedError):
        VoxelNet(_override(override))


@pytest.mark.parametrize("override,warning", [
    ({"backbone3d": {"norm": "GN"}}, None), ({"backbone3d": {"drop": 0.1}}, None),
    ({"encoder": {"use_pointnet": True}}, "VoxelNet ignores"),
    ({"encoder": {"spatial": {"norm_type": "sync_batch"}}}, None)])
def test_ported_voxel_net_options_build(override, warning):
    """Ported now (tests/test_torch_voxelnet_options.py and
    tests/test_torch_spatial_options.py hold them against JAX): GN and
    dropout build silently, sync_batch is batch on one card, the pointnet
    flag the JAX VoxelNet ignores warns."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        model = VoxelNet(_override(override))
    said = [str(w.message) for w in caught if issubclass(w.category, UserWarning)]
    assert (warning is None and not said) or (warning and any(warning in m for m in said))
    assert isinstance(model, VoxelNet)


def test_drive_config_is_supported():
    """The drive config builds: nnSyncBN is BN on one card, heads.tsdf.*
    flattens onto tsdf_*, spatial.out_channels follows channels[0]."""
    cfg = config_from_dict(VoxelNetConfig, load_experiment_model_config(
        os.path.join(REPO, "configs", "experiment", "seqs_multigeo_voxelnet.yaml")))
    check_supported_voxel_net(cfg)
    assert cfg.backbone3d.norm == "nnSyncBN" and cfg.heads.tsdf_label_smoothing == 1.05
    assert cfg.heads.tsdf_loss_split == "pred" and cfg.voxel_sizes == (4, 8)
    assert cfg.encoder.spatial.backbone == "resnet18" and cfg.scheduler.step_size == 120


@pytest.mark.parametrize("precision", ["bf16-mixed", "16-mixed"])
def test_gen_nerf_under_bf16_still_raises(tmp_path, precision):
    """A GenNerf config under a mixed precision builds in bf16 now
    (tests/test_torch_gennerf_bf16.py); an option still refused raises
    under it as under float32, in the train and predict CLIs alike, and
    distillation (use_distill, use_auxiliary) builds under it
    (tests/test_torch_options_bf16.py)."""
    exp = os.path.join(REPO, "configs", "experiment", "seqs_multigeo_4cm.yaml")
    unported = "model.sampling_mode=grid"
    with pytest.raises(NotImplementedError, match="sampling_mode"):
        train_main(["--config", exp, "--out", str(tmp_path / "run"), "--synthetic",
                    "--device", "cpu", f"trainer.precision={precision}", unported])
    with pytest.raises(NotImplementedError, match="sampling_mode"):
        predict_main(["--config", exp, "--frames", str(tmp_path / "f.npz"),
                      "--out", str(tmp_path / "o.npz"), "--device", "cpu",
                      f"trainer.precision={precision}", unported])
    model = build_model(load_experiment_model_config(exp), "cpu", 0, precision)
    assert model.dtype == torch.bfloat16
    distill = load_experiment_model_config(
        os.path.join(REPO, "configs", "experiment", "distill_synthetic.yaml"))
    assert build_model(distill, "cpu", 0, precision).dtype == torch.bfloat16
    distill["loss"]["use_distill"] = False
    distill["encoder"].update(use_auxiliary=True, auxiliary_dim=distill["teacher"]["feature_dim"])
    assert build_model(distill, "cpu", 0, precision).dtype == torch.bfloat16
    distill["teacher"]["type"] = "clip"
    with pytest.raises(NotImplementedError, match="teacher.type"):
        build_model(distill, "cpu", 0, precision)


def test_render_cli_refuses_voxel_net(tmp_path):
    with pytest.raises(SystemExit, match="GenNerf"):
        render_main(["--config", os.path.join(REPO, "configs", "experiment",
                                              "seqs_multigeo_voxelnet.yaml"),
                     "--frames", str(tmp_path / "f.npz"), "--out", str(tmp_path / "o"),
                     "--device", "cpu"])


# -- upsamples ----------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 3, 4, 6, 2), (2, 2, 5, 3, 7)])
def test_trilinear_up2x(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    ref = j_up2x(jnp.asarray(x.transpose(0, 2, 3, 4, 1)))
    np.testing.assert_allclose(trilinear_up2x(_t(x)).numpy(),
                               np.asarray(ref).transpose(0, 4, 1, 2, 3), rtol=0, atol=1e-6)


def test_nearest_upsample(rng):
    x = rng.standard_normal((1, 2, 3, 5, 4)).astype(np.float32)
    np.testing.assert_array_equal(upsample2x_nearest3d(_t(x)).numpy(), np.asarray(j_nearest(x)))


# -- 3D encoder-decoder -----------------------------------------------------------------

def _b3d_state(params: dict, stats: dict) -> dict:
    """The port's EncoderDecoder state_dict of flax EncoderDecoder variables."""
    tree = {"spatial": {"resnet": {}, "proj": {"kernel": np.zeros((1, 1, 1, 1))}},
            "backbone3d": params, "heads3d": {"tsdf_head": {}}}
    return {k.removeprefix("backbone3d."): v for k, v in voxel_net_params_from_flax(
        tree, {"backbone3d": stats}).items() if k.startswith("backbone3d.")}


_B3D_CACHE = {}


def _b3d_reference(cond_proj: bool, train: bool, x):
    """The JAX EncoderDecoder's randomized variables, outputs and new
    running statistics on x, without remat (remat recomputes the same
    values; the port runs both ways against it), cached per case."""
    if cond_proj not in _B3D_CACHE:
        jm = JEncoderDecoder(channels=CHANNELS, layers_down=(1, 2, 3), layers_up=(2, 1),
                             cond_proj=cond_proj)
        variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
        params, stats = _randomize(dict(variables["params"]), dict(variables["batch_stats"]), 7)
        _B3D_CACHE[cond_proj] = jm, {"params": params, "batch_stats": stats}
    jm, variables = _B3D_CACHE[cond_proj]
    if (cond_proj, train) not in _B3D_CACHE:
        # op by op: one call, cheaper than compiling it
        _B3D_CACHE[cond_proj, train] = jm.apply(variables, jnp.asarray(x), train=train,
                                                mutable=["batch_stats"])
    return variables, *_B3D_CACHE[cond_proj, train]


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("cond_proj", [False, True])
@pytest.mark.parametrize("train", [False, True])
def test_encoder_decoder(train, cond_proj, remat):
    """Outputs (coarse -> fine) and, in training mode, the new running
    statistics; a quarter of the input voxels are zero (unobserved), which
    the masked skip sees. With remat the port's gradients equal those of
    the same module without remat."""
    x = np.random.default_rng(0).standard_normal((1, CHANNELS[0], *VD)).astype(np.float32) + 0.5
    x[:, :, :, :, :2] = 0.0
    variables, ref, mutated = _b3d_reference(cond_proj, train, x)
    tm = EncoderDecoder(CHANNELS, (1, 2, 3), (2, 1), cond_proj=cond_proj, remat=remat)
    tm.load_state_dict(_b3d_state(variables["params"], variables["batch_stats"]))
    tm.train(train)
    outs = tm(_t(x))
    assert [o.dtype for o in outs] == [torch.float32] * 2
    for o, r in zip(outs, ref):
        _close(o, r, rtol=1e-5, floor=3e-5 if train else 1e-5)
    if train:
        ref_sd = _b3d_state(variables["params"], jax.tree.map(np.asarray, mutated["batch_stats"]))
        for k, v in tm.state_dict().items():
            if "running_" in k:
                _close(v, ref_sd[k].numpy())
    if remat:
        plain = EncoderDecoder(CHANNELS, (1, 2, 3), (2, 1), cond_proj=cond_proj).train(train)
        before = {k: v.clone() for k, v in tm.state_dict().items()}
        tm.load_state_dict(before)
        plain.load_state_dict(before)
        grads = []
        for m in (tm, plain):
            m.zero_grad()
            loss = sum((o * o).mean() for o in m(_t(x)))
            loss.backward()
            grads.append({n: p.grad.clone() for n, p in m.named_parameters()})
        for n in grads[1]:
            _close(grads[0][n], grads[1][n].numpy(), rtol=1e-6)
        if train:  # the recompute left the statistics alone: one move, as without remat
            tm.load_state_dict(before)
            plain.load_state_dict(before)
            tm(_t(x))[0].sum().backward()
            plain(_t(x))
            for k, v in plain.state_dict().items():
                assert torch.equal(tm.state_dict()[k], v), k


def test_encoder_decoder_without_norm():
    """norm '': no norm layers, and the strided down convolutions carry a
    bias (zero at init, drawn at random here)."""
    x = np.random.default_rng(1).standard_normal((1, CHANNELS[0], *VD)).astype(np.float32)
    jm = JEncoderDecoder(channels=CHANNELS, layers_down=(1, 2, 3), layers_up=(2, 1),
                         cond_proj=False, norm="")
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    rng = np.random.default_rng(2)
    for i in (1, 2):
        params[f"down{i}_conv"]["bias"] = rng.standard_normal(CHANNELS[i]).astype(np.float32)
    ref = jm.apply({"params": params}, jnp.asarray(x))
    tm = EncoderDecoder(CHANNELS, (1, 2, 3), (2, 1), norm="", cond_proj=False).train()
    tm.load_state_dict(_b3d_state(params, {}))
    assert tm.layers_down[1][0].bias is not None and tm.layers_down[0][0].conv1.bias is None
    for o, r in zip(tm(_t(x)), ref):
        _close(o, r)


# -- heads ------------------------------------------------------------------------------

@pytest.mark.parametrize("multi_scale,split,missing", [
    (True, "pred", None), (True, "none", None), (False, "pred", None),
    (True, "pred", "vol_16_tsdf"), (True, "pred", "vol_08_tsdf")])
def test_voxel_heads(rng, multi_scale, split, missing):
    """Outputs and losses of the heads on random up-path volumes (coarse
    8x8x4 with 16 channels, fine 16x16x8 with 8), the targets with a
    column all +1 (mask_outside over nz) and, where asked, a scale absent."""
    xs = [rng.standard_normal((1, 16, 8, 8, 4)).astype(np.float32) * 2,
          rng.standard_normal((1, 8, *VD)).astype(np.float32) * 2]
    b = _batch(seed=4)
    targets = {k: b[k] for k in KEYS if k != missing}
    kw = dict(voxel_size=VS, tsdf_multi_scale=multi_scale, tsdf_loss_split=split)
    jm = JVoxelHeads(channels=CHANNELS, **kw)
    variables = jm.init(jax.random.PRNGKey(2), [jnp.asarray(x) for x in xs])
    ref_out, ref_loss = jm.apply(variables, [jnp.asarray(x) for x in xs],
                                 {k: jnp.asarray(v) for k, v in targets.items()})
    tree = {"spatial": {"resnet": {}, "proj": {"kernel": np.zeros((1, 1, 1, 1))}},
            "backbone3d": {}, "heads3d": jax.tree.map(np.asarray, dict(variables["params"]))}
    sd = {k.removeprefix("heads3d."): v for k, v in voxel_net_params_from_flax(tree).items()
          if k.startswith("heads3d.")}
    tm = VoxelHeads(CHANNELS, **kw)
    tm.load_state_dict(sd)
    out, loss = tm([_t(x) for x in xs], {k: _t(v) for k, v in targets.items()})
    assert set(out) == set(ref_out) and set(loss) == set(ref_loss)
    assert len(loss) == (1 if missing or not multi_scale else 2)
    for k in ref_out:
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(ref_out[k]), rtol=0,
                                   atol=1e-6)
    for k in ref_loss:
        assert float(loss[k]) == pytest.approx(float(ref_loss[k]), abs=1e-6)
    if split == "pred" and multi_scale:  # the sparsified voxels carry the coarse sign
        assert (out["vol_08_tsdf"].abs() == 0.999).any()


# -- VoxelNet ---------------------------------------------------------------------------

@pytest.mark.parametrize("train", [False, True])
def test_voxel_net_forward(pair, jax_forward, train):
    """Outputs, losses and (train) new running statistics of the whole
    model. In train mode the outputs are refereed by the port's float64
    evaluation of the same network: the JAX model in float64 (x64) within
    the train-mode bound of it (the weights mapped alike), and the port's
    float32 output no farther from it than JAX's float32 output and within
    3e-5 of its max-abs. Both float32 outputs lie 1.2e-5 to 2.4e-5 of
    max-abs from float64 (JAX's E[x^2] - E[x]^2 variance the farther), so
    the two float32 outputs read up to 2.9e-5 apart at 8 threads: they are
    not compared with each other."""
    task, params, stats, b = pair
    ref_out, ref_loss, ref_stats = jax_forward(train)
    model = _port(params, stats)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    out, loss = _port_forward(model, b, train)
    if not train:
        for k in ref_out:
            _close(out[k], ref_out[k], rtol=1e-5, floor=1e-5)
    for k in ref_loss:
        assert float(loss[k]) == pytest.approx(ref_loss[k], rel=1e-5)
    if train:
        _, new_stats = flax_variables_from_voxel_net(model.state_dict())
        for path, ref in jax.tree_util.tree_flatten_with_path(ref_stats)[0]:
            _close(_leaf(new_stats, path), ref)
        m64 = _float64_copy(model, before)
        with torch.no_grad():
            out64, _ = m64(_t(b["projection"]), _t(b["image"]).double(), VD)
        args = _jargs(b)
        with jax.enable_x64(True):
            (jax64, _), _ = JVoxelNet(task.cfg, dtype=jnp.float64).apply(
                jax.tree.map(lambda a: np.asarray(a, np.float64),
                             {"params": params, "batch_stats": stats}),
                *(a.astype(jnp.float64) for a in args[:3]), VD, args[4], None, train=True,
                mutable=["batch_stats"])
        assert set(out64) == set(jax64) == set(ref_out)
        for k in out64:
            _close(np.asarray(jax64[k]), out64[k].numpy(), rtol=1e-5, floor=3e-5)
            assert_nearer_float64(out[k], ref_out[k], out64[k], k, factor=1.0,
                                  cap=3e-5 * float(out64[k].abs().max()))


def _leaf(tree, path):
    for p in path:
        tree = tree[p.key]
    return tree


def _float64_copy(model, state):
    m = VoxelNet(model.cfg).double()
    m.load_state_dict({k: v.double() for k, v in state.items()})
    return m.train()


def test_voxel_net_loss_and_gradients(pair):
    """One train-mode forward's summed loss and every parameter's gradient
    against jax.value_and_grad of the JAX train step's loss."""
    task, params, stats, b = pair
    args = _jargs(b)
    model = _port(params, stats)

    def loss_fn(p):
        (_, losses), _ = task.model.apply({"params": p, "batch_stats": stats}, *args,
                                          train=True, mutable=["batch_stats"])
        return sum(losses.values())

    with jax.default_matmul_precision("highest"):
        ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    model.train()
    loss, metrics = voxel_net_forward_loss(model, {k: _t(v) for k, v in b.items()})
    loss.backward()
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-5)
    assert float(metrics["tsdf_loss"]) == float(loss)
    grads = voxel_net_params_from_flax(jax.tree.map(np.asarray, ref_grads))
    named = dict(model.named_parameters())
    assert set(grads) == set(named)
    for n, g in grads.items():
        _close(named[n].grad, g.numpy(), rtol=1e-4)


def _float64_first_gradients(model, batch) -> dict:
    """Every parameter's gradient of the first step's loss, taken on a
    float64 copy of `model` and the batch (the projections stay float32:
    the backprojection's voxel lookup is float32; every product and every
    gradient's sum is float64)."""
    m64 = copy.deepcopy(model).double().train()
    b64 = {k: torch.from_numpy(np.asarray(v, np.float64)) for k, v in batch.items()}
    _, losses = m64(_t(batch["projection"]), b64["image"], VD, None, {k: b64[k] for k in KEYS})
    sum(losses.values()).backward()
    return {n: p.grad.detach() for n, p in m64.named_parameters()}


def test_two_adam_steps(pair):
    """Two steps of the port's train_step against make_voxel_net_train_step:
    the metrics, then every parameter and running statistic. Under
    loss_split 'none': with 'pred' the finer scale's loss mask and values
    jump where a coarse prediction crosses the sparse threshold, and after
    one step a voxel on the threshold can fall on either side in the two
    frameworks (the forward and gradient tests above cover 'pred').

    Adam's first update moves a parameter by lr * g / (|g| + 1e-8): by lr
    in the gradient's sign, whatever its size. Where a first gradient is
    below the float32 noise of its tensor's backward (some of the ResNet
    stem's weights), its sign depends on the summation order, which changes
    with the thread count, and the update lands a step of lr the other way
    in one framework; the second step's gradients then differ elsewhere
    too. Those first gradients are held to a float64 step instead: an
    element whose float64 gradient is within the noise floor (1e-4 of its
    tensor's largest float64 gradient, the bound of the gradient test
    above) takes JAX's first update, and the port's float32 gradient, every
    element of it, must lie within that floor of the float64 one. Every
    other element keeps the 0.25 lr bound against JAX after two steps."""
    from gennerf_tpu.train.state import create_train_state

    _, params, stats, b = pair
    cfg = {**CFG, "heads": {"use_tsdf": True, "tsdf": {"multi_scale": True, "loss_split": "none"}}}
    task = VoxelNetTask(cfg)
    state = create_train_state({"params": params, "batch_stats": stats}, task.tx)
    model = _port(params, stats, cfg)
    g64 = _float64_first_gradients(model, b)
    opt = make_optimizer(model.parameters(), model.cfg.optimizer)
    batch = batch_to_device(b, "cpu")
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    noise = {}
    for step, rel in enumerate((1e-5, 1e-4)):
        with jax.default_matmul_precision("highest"):
            state, ref = task.train_step(state, jb, jax.random.PRNGKey(0))
        metrics = train_step(model, opt, batch)
        assert set(metrics) == set(ref)
        for k in ref:
            assert float(metrics[k]) == pytest.approx(float(ref[k]), rel=rel), k
        if step:
            continue
        first = voxel_net_params_from_flax(jax.tree.map(np.asarray, state.params))
        with torch.no_grad():
            for n, p in model.named_parameters():
                floor = 1e-4 * float(g64[n].abs().max())
                assert float((p.grad.double() - g64[n]).abs().max()) <= floor, n
                noise[n] = g64[n].abs() <= floor
                p[noise[n]] = first[n][noise[n]]
    ref_sd = voxel_net_params_from_flax(jax.tree.map(np.asarray, state.params),
                                        jax.tree.map(np.asarray, state.batch_stats))
    lr, far = model.cfg.optimizer.lr, []
    for k, v in model.state_dict().items():
        if "running_" in k:
            _close(v, ref_sd[k].numpy(), rtol=1e-4)
            continue
        diff = (v - ref_sd[k]).abs()
        assert float(torch.where(noise[k], 0.0, diff).max()) <= 0.25 * lr, k
        far.append((diff > 1e-2 * lr).flatten())
    assert float(torch.cat(far).float().mean()) <= 1e-3


@pytest.mark.parametrize("mask_unobserved", [True, False])
def test_reconstruct_matches_jax(pair, mask_unobserved):
    """reconstruct (the finest scale at the ground truth's grid, the fusion
    prior under mask_unobserved) against VoxelNetTask.reconstruct."""
    from gennerf_tpu.train.state import TrainState

    _, params, stats, b = pair
    cfg = {**CFG, "mask_unobserved": mask_unobserved}
    task = VoxelNetTask(cfg)
    state = TrainState(step=0, params=params, batch_stats=stats, opt_state=None)
    with jax.default_matmul_precision("highest"):
        pred, trgt = task.reconstruct(state, b)
    vol = reconstruct(_port(params, stats, cfg), b["projection"][0], b["image"][0], b["depth"][0], VD)
    assert vol.dtype == torch.float32 and tuple(vol.shape) == VD
    _close(vol, pred.tsdf_vol)
    np.testing.assert_array_equal(np.asarray(trgt.tsdf_vol), b["vol_08_tsdf"][0, 0])
    assert bool((vol == 1).any()) == mask_unobserved  # the prior's +1 outside every frustum


def test_params_round_trip_through_npz(pair, tmp_path):
    """flax params and batch_stats -> port -> npz -> port -> flax: equal."""
    _, params, stats, _ = pair
    model = _port(params, stats)
    path = str(tmp_path / "p.npz")
    save_params_npz(path, voxel_net_npz_tree(model.state_dict()))
    again = VoxelNet(model.cfg)
    again.load_state_dict(voxel_net_params_from_flax(load_params_npz(path)))
    p2, s2 = flax_variables_from_voxel_net(again.state_dict())
    for ref, tree in ((params, p2), (stats, s2)):
        assert jax.tree.structure(ref) == jax.tree.structure(tree)
        for a, c in zip(jax.tree.leaves(ref), jax.tree.leaves(tree)):
            np.testing.assert_array_equal(a, c)


# -- bf16-mixed -------------------------------------------------------------------------

def _flax_to_torch_module(path) -> str:
    """A flax module path of the JAX VoxelNet -> the port's module name
    (flax's BatchNorm_0 inside a 3D norm is the port's norm itself)."""
    from gennerf_tpu_torch.utils.port_params import _b3d_prefix

    parts = [p for p in path if p != "BatchNorm_0"]
    if not parts:
        return ""
    if parts[0] == "spatial":
        out = ["spatial"]
        for p in parts[1:]:
            if p.startswith("layer"):
                out += p.split("_")
            else:
                out.append({"down_conv": "downsample.0", "down_bn": "downsample.1"}.get(p, p))
        return ".".join(out)
    if parts[0] == "backbone3d":
        if len(parts) == 1:
            return "backbone3d"
        return ".".join(["backbone3d", _b3d_prefix(parts[1])] + [
            {"down": "downsample"}.get(p, p) for p in parts[2:]])
    out = "heads3d"  # heads3d / tsdf_head / decoder_{i}
    if len(parts) > 1:
        out += ".heads.0"
    if len(parts) > 2:
        out += ".decoders." + parts[2].removeprefix("decoder_")
    return out


def _dtypes(x):
    if isinstance(x, torch.Tensor):
        return [x.dtype]
    if isinstance(x, dict):
        return [d for k in sorted(x) for d in _dtypes(x[k])]
    if isinstance(x, (list, tuple)):
        return [d for v in x for d in _dtypes(v)]
    return []


def test_bf16_output_dtypes_match_flax(pair):
    """Every module the JAX model calls, its output dtypes against the
    port's module of that name (forward hooks), train mode, bf16-mixed:
    convolutions bf16, the ResNet's norms bf16, the 3D norms, blocks and
    backbone float32, the head decoders bf16 and the heads float32."""
    _, params, stats, b = pair
    jm = VoxelNetTask(CFG, "bf16-mixed").model
    _, inter = jm.apply({"params": params, "batch_stats": stats}, *_jargs(b), train=True,
                        mutable=["batch_stats", "intermediates"], capture_intermediates=True)
    ref = {}

    def walk(t, path=()):
        for k, v in t.items():
            if k == "__call__":
                ref.setdefault(_flax_to_torch_module(path), [
                    {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}[a.dtype.type]
                    for a in jax.tree.leaves(v) if hasattr(a, "dtype")])
            else:
                walk(v, path + (k,))

    walk(inter["intermediates"])
    m16 = _port(params, stats, dtype=torch.bfloat16)
    seen = {}
    modules = dict(m16.named_modules())
    def hook(name):
        def record(module, args, out):
            seen.setdefault(name, _dtypes(out))
        return record

    hooks = [modules[name].register_forward_hook(hook(name)) for name in ref if name in modules]
    _port_forward(m16, b, train=True)
    for h in hooks:
        h.remove()
    assert set(seen) == set(ref) and len(seen) > 60
    for name, dtypes in ref.items():
        assert seen[name] == dtypes, name
    assert seen["spatial.resnet.bn1"] == [torch.bfloat16]
    assert seen["backbone3d.layers_down.1.1"] == [torch.float32]


@pytest.mark.parametrize("train", [False, True])
def test_bf16_outputs_near_jax_bf16(pair, jax_forward, train):
    """The port's bf16-mixed outputs and losses against JAX's (see the
    module docstring for both bounds)."""
    _, params, stats, b = pair
    out32, loss32, _ = jax_forward(train)
    out16, loss16, _ = jax_forward(train, jnp.bfloat16)
    ours, ours_loss = _port_forward(_port(params, stats, dtype=torch.bfloat16), b, train)
    for k in out32:
        assert ours[k].dtype == torch.float32
        gap = np.abs(out16[k] - out32[k]).mean()
        err = np.abs(ours[k].numpy() - out16[k]).mean()
        assert err <= 0.5 * gap and err <= (1e-2 if train else 1e-4), (k, err, gap)
    for k in loss32:
        assert abs(float(ours_loss[k]) - loss16[k]) <= 0.5 * abs(loss16[k] - loss32[k]) + 1e-6


def test_bf16_step_keeps_float32_state(pair):
    """One bf16-mixed train step: the loss finite, every parameter, its
    gradient and every running statistic float32 (and the statistics
    moved)."""
    _, params, stats, b = pair
    model, m16 = _port(params, stats), _port(params, stats, dtype=torch.bfloat16)
    opt = make_optimizer(m16.parameters(), m16.cfg.optimizer)
    metrics = train_step(m16, opt, batch_to_device(b, "cpu"))
    assert np.isfinite(float(metrics["tsdf_loss"]))
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in m16.parameters())
    moved = 0
    for k, v in m16.state_dict().items():
        assert v.dtype == torch.float32, k
        moved += "running_mean" in k and not torch.equal(v, model.state_dict()[k])
    assert moved == sum("running_mean" in k for k in model.state_dict())


# -- the CLIs ---------------------------------------------------------------------------

TINY_VOXELNET = (
    "defaults:\n  - seqs_multigeo_voxelnet\n"
    "model:\n  encoder:\n    spatial: {num_layers: 2, feature_scale: 0.25}\n"
    "  backbone3d: {channels: [8, 16, 32]}\n"
    "trainer: {log_every_n_steps: 1, check_val_every_n_epoch: 1}\n"
    "data:\n  voxel_size: 0.08\n  voxel_dim_train: [16, 16, 8]\n  voxel_dim_val: [16, 16, 8]\n"
    "  voxel_dim_test: [24, 24, 12]\n  num_frames_train: 2\n  num_frames_val: 2\n"
    "  num_frames_test: 2\n  sequence_length: 3\n  num_workers_train: 2\n"
    "  num_workers_val: 0\n  num_workers_test: 0\n")


@pytest.mark.parametrize("precision", ["bf16-mixed"])
def test_train_predict_evaluate_clis(tmp_path, precision):
    """On a dataset of two scenes (3 frames of 24x32, ground truth at 8 and
    16 cm) the train CLI trains a child of seqs_multigeo_voxelnet for one
    epoch in bf16-mixed (the val_tsdf_loss-monitored checkpoints and
    params.npz with batch_stats/), the predict CLI reconstructs both scenes
    from the run directory in the training precision, and the evaluation
    CLI scores them; an f32 override is accepted too."""
    root = str(tmp_path / "data")
    rng = np.random.default_rng(0)
    infos = [os.path.relpath(generate_scene(root, scene=f"scene_{fam}", num_frames=3, H=24, W=32,
                                            voxel_sizes=(8, 16), seed=i,
                                            primitives=random_primitives(rng, fam)), root)
             for i, fam in enumerate(("spheres", "boxes"))]
    for split in ("train.txt", "val.txt"):
        with open(os.path.join(root, split), "w") as f:
            f.write("\n".join(infos) + "\n")
    shutil.copytree(os.path.join(REPO, "configs"), tmp_path / "configs")
    exp = tmp_path / "configs" / "experiment" / "tiny_voxelnet.yaml"
    exp.write_text(TINY_VOXELNET)
    run = tmp_path / "run"
    trainer = train_main(["--config", str(exp), "--out", str(run), "--data-dir", root,
                          "--epochs", "1", "--device", "cpu"])
    assert trainer.model.dtype == torch.bfloat16 and trainer.global_step == 2
    assert {"train_tsdf_loss", "train_vol_08_tsdf_loss", "train_vol_16_tsdf_loss",
            "val_tsdf_loss", "val_recon_tsdf_l1"} <= set(trainer.metrics)
    assert np.isfinite(trainer.metrics["val_recon_tsdf_l1"])
    tree = load_params_npz(str(run / "params.npz"))
    assert {"spatial", "backbone3d", "heads3d", "batch_stats"} <= set(tree)
    with open(run / "checkpoints" / "checkpoints.json") as f:
        assert "val_tsdf_loss" in f.read()
    pred = tmp_path / "pred"
    results = predict_main(["--config", str(exp), "--ckpt", str(run), "--data-dir", root,
                            "--split", "val.txt", "--out", str(pred), "--device", "cpu"])
    assert len(results) == 2
    with open(pred / "predict_meta.json") as f:
        meta = __import__("json").load(f)
    assert meta["precision"] == precision and meta["selected_by"] == "val_tsdf_loss"
    evaluation_main(["--results", str(pred), "--dataset", "val.txt", "--data-dir", root,
                     "--device", "cpu"])
    with open(pred / "metrics_mean.json") as f:
        mean = __import__("json").load(f)
    assert np.isfinite(mean["l1"]) and np.isfinite(mean["AbsRel"])
    f32 = train_main(["--config", str(exp), "--out", str(tmp_path / "run32"), "--data-dir", root,
                      "--epochs", "1", "--device", "cpu", "trainer.precision=32-true"])
    assert f32.model.dtype == torch.float32
