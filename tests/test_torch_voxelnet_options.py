"""VoxelNet's remaining options in the port against the JAX package on the
CPU: backbone3d.norm 'GN' (flax's GroupNorm; the module, a forward in eval
and train mode, one train step's loss and gradients), backbone3d.drop > 0
(the JAX dropout masks captured and injected: loss and gradients with and
without remat; the masks the port draws itself, remat replaying them),
every heads.tsdf_loss_split value (an unknown one computes 'none' and
warns), the two encoder flags the JAX VoxelNet ignores (a warning, and
its outputs), heads.use_tsdf false (refused, as the JAX train step fails
on it), and GN with dropout under bf16-mixed against JAX's op-by-op bf16.

Sizes are small: resnet18 at num_layers 2 on 2 frames of 32x40, a 16^3
volume at 8 cm, channels [8, 16, 32], layers_down [1, 2, 3], layers [2, 1],
heads at 16 and 8 cm. JAX runs under default_matmul_precision("highest"),
the port with TF32 off. Every norm's scale and bias (the zero-init bn2
scales too) and the ResNet's running statistics are drawn at random.

The JAX masks: flax draws each nn.Dropout's mask from make_rng('dropout')
in call order; the test wraps `flax.linen.Dropout.__call__` (monkeypatch;
nothing in gennerf_tpu/ changes) with a copy of flax's own body that
records the mask, in a forward apply with the step's key, and the port
takes them channels-first through `StepDraws.dropout`. The JAX references
themselves run flax's unpatched Dropout with the same key (JAX's remat
replays the key: its masks are the same with remat on).

Tolerances, float32: losses and the new running statistics within 1e-5
relative with a floor of 1e-5 of the tensor's largest magnitude; the GN
output volumes refereed by a float64 refine (see test_gn_forward_matches_jax:
GroupNorm takes E[x^2] - E[x]^2 in both packages, in another summation
order, and JAX's float32 is the farther from float64); other outputs
within 1e-5 of the largest magnitude; gradients within 1e-4 of their tensor's largest
magnitude (the tests/test_torch_train.py bound: the same float32
differences carried back through every norm's statistics), the GN step's
refereed by a float64 step (its docstring, tests/_torch_referee.py). bf16-mixed:
the bounds of tests/test_torch_voxelnet.py: each output volume's mean
absolute difference to JAX's bf16 output at most half of JAX's own
bf16-to-float32 mean distance, and within 1e-2 (train mode); the losses
within half of JAX's bf16-to-float32 distance (+1e-6).
"""
import copy
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from jax import lax, random

from gennerf_tpu.models.backbone3d import _Norm3d as JNorm3d
from gennerf_tpu.models.voxel_net import VoxelNet as JVoxelNet
from gennerf_tpu.train.state import create_train_state
from gennerf_tpu.train.tasks import VoxelNetTask
from gennerf_tpu_torch.data.synthetic import training_batch
from gennerf_tpu_torch.models.backbone3d import DropoutDraws, norm3d
from gennerf_tpu_torch.models.config import VoxelNetConfig, config_from_dict
from gennerf_tpu_torch.models.voxel_net import VolumeRepr, VoxelNet
from gennerf_tpu_torch.train.step import StepDraws, batch_to_device, voxel_net_forward_loss
from gennerf_tpu_torch.utils.port_params import voxel_net_params_from_flax

import _torch_threads  # noqa: F401  (sizes torch's threads per xdist worker)
from _torch_referee import assert_nearer_float64

VD = (16, 16, 16)
VS = 0.08
KEYS = ("vol_08_tsdf", "vol_16_tsdf")
DROP = 0.2
CFG = {"type": "VoxelNet", "voxel_size": VS, "voxel_dim_train": list(VD),
       "voxel_dim_val": list(VD), "voxel_dim_test": list(VD),
       "encoder": {"use_spatial": True, "use_pointnet": False,
                   "spatial": {"backbone": "resnet18", "num_layers": 2, "feature_scale": 1.0,
                               "blur_image": False}},
       "backbone3d": {"channels": [8, 16, 32], "layers_down": [1, 2, 3], "layers": [2, 1],
                      "norm": "GN", "conditional_skip": True},
       "heads": {"use_tsdf": True, "tsdf": {"multi_scale": True, "loss_split": "pred"}},
       "optimizer": {"type": "Adam", "lr": 0.001, "weight_decay": 0.0}}


def _cfg(**over) -> dict:
    """CFG with `section={key: value}` merged one level deep (a spatial
    override under encoder.spatial)."""
    cfg = copy.deepcopy(CFG)
    for section, values in over.items():
        for k, v in values.items():
            if isinstance(v, dict):
                cfg[section].setdefault(k, {}).update(v)
            else:
                cfg[section][k] = v
    return cfg


@pytest.fixture(autouse=True)
def _f32_highest():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with jax.default_matmul_precision("highest"):
        yield


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(ours, ref, rtol=1e-5, floor=None, name=""):
    ref = np.asarray(ref, np.float32)
    ours = ours.detach().float().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    assert ours.shape == ref.shape, name
    floor = rtol if floor is None else floor
    np.testing.assert_allclose(ours, ref, rtol=rtol, err_msg=name,
                               atol=floor * max(float(np.abs(ref).max()), 1e-30))


def _batch(seed=3):
    b = training_batch(1, 2, 32, 40, VD, VS, seed=seed)
    rng = np.random.default_rng(seed)
    b["vol_16_tsdf"] = np.clip(rng.uniform(-1.3, 1.3, (1, 1, 8, 8, 8)), -1, 1).astype(np.float32)
    b["vol_16_tsdf"][0, 0, 1, 2, :] = 1.0
    return b


def _jargs(b):
    return (jnp.asarray(b["projection"]), jnp.asarray(b["image"]), jnp.asarray(b["depth"]), VD,
            jnp.zeros(3), {k: jnp.asarray(b[k]) for k in KEYS})


def _randomize(params: dict, stats: dict, seed: int):
    """numpy copies with every norm's scale and bias (GroupNorm's and
    BatchNorm's) and the BatchNorm running statistics drawn at random."""
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
                if k in s:
                    s[k]["mean"] = (0.1 * rng.standard_normal(s[k]["mean"].shape)).astype(
                        np.float32)
                    s[k]["var"] = rng.uniform(0.5, 2.0, s[k]["var"].shape).astype(np.float32)
            else:
                walk(v, s.get(k, {}))

    walk(params, stats)
    return params, stats


@pytest.fixture(scope="module")
def weights():
    """Randomized variables of the GN VoxelNet (dropout and the loss split
    add no parameter, so every config here shares them) and the batch."""
    with jax.default_matmul_precision("highest"):
        b = _batch()
        variables = jax.jit(VoxelNetTask(CFG).model.init, static_argnums=(4,))(
            jax.random.PRNGKey(0), *_jargs(b)[:5])
    params, stats = _randomize(dict(variables["params"]), dict(variables["batch_stats"]), 5)
    return params, stats, b


def _port(weights, cfg=CFG, dtype=torch.float32) -> VoxelNet:
    params, stats, _ = weights
    model = VoxelNet(config_from_dict(VoxelNetConfig, cfg), dtype=dtype)
    model.load_state_dict(voxel_net_params_from_flax(params, stats))
    return model


def _jax_apply(cfg, weights, train, key=None, dtype=None):
    """The JAX VoxelNet's (outputs, losses, new batch_stats), op by op."""
    params, stats, b = weights
    model = VoxelNetTask(cfg, dtype).model
    (out, losses), mutated = model.apply(
        {"params": params, "batch_stats": stats}, *_jargs(b),
        train=train, mutable=["batch_stats"], rngs=None if key is None else {"dropout": key})
    return out, losses, mutated["batch_stats"]


def _jax_value_and_grad(cfg, weights, key=None):
    params, stats, b = weights
    model = VoxelNetTask(cfg).model

    def loss_fn(p):
        (_, losses), _ = model.apply({"params": p, "batch_stats": stats}, *_jargs(b), train=True,
                                     mutable=["batch_stats"],
                                     rngs=None if key is None else {"dropout": key})
        return sum(losses.values())

    return jax.jit(jax.value_and_grad(loss_fn))(params)


def _port_forward(model, b, train, masks=None):
    model.train(train)
    with torch.no_grad():
        return voxel_net_forward_loss(model, batch_to_device(b, "cpu"),
                                      draws=StepDraws(dropout=masks))


def _check_grads(model, ref_grads):
    grads = voxel_net_params_from_flax(jax.tree.map(np.asarray, ref_grads))
    named = dict(model.named_parameters())
    assert set(grads) == set(named)
    for n, g in grads.items():
        _close(named[n].grad, g.numpy(), rtol=1e-4, name=n)


_MASKS = {}


def jax_dropout_masks(monkeypatch, cfg, weights, key):
    """The keep masks of the JAX forward with `key`, channels-first, in
    call order: flax's Dropout body, recording its mask (once per key and
    rate: remat does not change them)."""
    cache_key = (tuple(np.asarray(key).tolist()), cfg["backbone3d"]["drop"])
    if cache_key in _MASKS:
        return _MASKS[cache_key]
    masks = []

    def call(self, inputs, deterministic=None, rng=None):
        deterministic = fnn.module.merge_param("deterministic", self.deterministic,
                                               deterministic)
        if self.rate == 0.0 or deterministic:
            return inputs
        keep = 1.0 - self.rate
        rng = self.make_rng(self.rng_collection) if rng is None else rng
        mask = random.bernoulli(rng, p=keep, shape=inputs.shape)
        masks.append(mask)
        return lax.select(mask, inputs / keep, jnp.zeros_like(inputs))

    with monkeypatch.context() as m:
        m.setattr(fnn.Dropout, "__call__", call)
        _jax_apply(cfg, weights, True, key)
    _MASKS[cache_key] = [_t(np.asarray(mk)).permute(0, 4, 1, 2, 3) for mk in masks]
    return _MASKS[cache_key]


# -- GroupNorm --------------------------------------------------------------------------

@pytest.mark.parametrize("channels,zero_init,dtype", [
    (8, False, jnp.float32), (64, True, jnp.float32), (16, False, jnp.bfloat16)],
    ids=["8", "64_zero_init", "16_bf16_input"])
def test_group_norm_is_flax(channels, zero_init, dtype):
    """norm3d('GN') against the JAX _Norm3d('GN') on a channels-last input:
    min(32, C) groups, the zero-init scale, float32 out of a bf16 input."""
    rng = np.random.default_rng(channels)
    x = (2.0 + rng.standard_normal((2, 5, 6, 7, channels))).astype(np.float32)
    jm = JNorm3d("GN", zero_init=zero_init)
    xj = jnp.asarray(x).astype(dtype)
    params = jax.tree.map(np.asarray, dict(jm.init(jax.random.PRNGKey(0), xj)["params"]))
    assert float(np.abs(params["GroupNorm_0"]["scale"]).max()) == (0.0 if zero_init else 1.0)
    params["GroupNorm_0"]["scale"] = rng.uniform(0.5, 1.5, channels).astype(np.float32)
    params["GroupNorm_0"]["bias"] = rng.standard_normal(channels).astype(np.float32)
    ref = jm.apply({"params": params}, xj)
    norm = norm3d("GN", channels, zero_init=zero_init)
    assert norm.num_groups == min(32, channels) and norm.eps == 1e-6
    norm.load_state_dict({"weight": _t(params["GroupNorm_0"]["scale"]),
                          "bias": _t(params["GroupNorm_0"]["bias"])})
    ours = norm(_t(np.asarray(xj.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32).permute(0, 4, 1, 2, 3))
    assert ours.dtype == torch.float32 and ref.dtype == jnp.float32
    _close(ours.permute(0, 2, 3, 4, 1), ref)


def _check_volumes(model, weights, out, train):
    """The port's output volumes against JAX's `out`, refereed by a float64
    refine of the port's own float32 volume (see test_gn_forward_matches_jax);
    returns the port's losses."""
    b = batch_to_device(weights[2], "cpu")
    with torch.no_grad():
        repr_ = model.encode(b["projection"], b["image"], VD)
        vols, losses = model.refine(repr_, {k: b[k] for k in KEYS})
        vols64, _ = _port(weights).double().train(train).refine(
            VolumeRepr(repr_.volume.double(), repr_.valid.double()))
    for k in out:
        ref64, ref = vols64[k].numpy(), np.asarray(out[k])
        ours = np.abs(vols[k].numpy() - ref64).max()
        assert ours <= min(np.abs(ref - ref64).max(), 3e-5 * np.abs(ref64).max()), k
    return losses


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_gn_forward_matches_jax(weights, train):
    """Losses, output volumes and (train mode) the spatial encoder's new
    running statistics of the GN VoxelNet. The volumes are refereed by a
    float64 refine of the port's own float32 volume: GroupNorm's variance
    E[x^2] - E[x]^2 cancels digits on the normalized volume's groups, and
    JAX's float32 output lies 4.2e-5 / 4.5e-5 of max-abs from float64
    where the port's lies 1.3e-5 / 1.5e-5, so the port is held nearer to
    float64 than JAX is and within 3e-5 of its max-abs (the referee
    tests/test_torch_voxelnet.py takes for train-mode BatchNorm)."""
    out, losses, new_stats = _jax_apply(CFG, weights, train)
    model = _port(weights).train(train)
    metrics = _check_volumes(model, weights, out, train)
    for k in losses:
        assert float(metrics[k]) == pytest.approx(float(losses[k]), rel=1e-5), k
    if train:
        ref_sd = voxel_net_params_from_flax(weights[0], jax.tree.map(np.asarray, new_stats))
        for k, v in model.state_dict().items():
            if "running_" in k:
                _close(v, ref_sd[k].numpy(), name=k)


def test_gn_step_matches_jax(weights):
    """One train-mode forward's summed loss and every gradient against
    jax.value_and_grad of the JAX train step's loss (GN, no dropout). The
    gradients are refereed by the port's float64 step on the same weights
    and batch: JAX's in float64 (x64) within 1e-4 of its tensor's max-abs
    (the weights mapped alike), the port's float32 gradients at most
    _torch_referee.FACTOR times as far from it as JAX's float32 ones and
    within 1e-4 of its max-abs (the file's gradient bound). Both float32
    steps lie up to 3e-5 (the port) and 4.8e-5 (JAX) of max-abs from
    float64, so the two read up to 0.54 of that bound against each other:
    they are not compared with each other."""
    params, stats, b = weights
    ref_loss, ref_grads = _jax_value_and_grad(CFG, weights)
    model = _port(weights).train()
    loss, metrics = voxel_net_forward_loss(model, batch_to_device(b, "cpu"))
    loss.backward()
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-5)
    m64 = copy.deepcopy(_port(weights)).double().train()
    b64 = {k: v.double() if v.is_floating_point() and k != "projection" else v
           for k, v in batch_to_device(b, "cpu").items()}  # the lookup stays float32
    voxel_net_forward_loss(m64, b64)[0].backward()
    with jax.enable_x64(True):
        model64 = JVoxelNet(VoxelNetTask(CFG).cfg, dtype=jnp.float64)
        args = _jargs(b)
        stats64 = jax.tree.map(lambda a: np.asarray(a, np.float64), stats)

        def loss_fn(p):
            (_, losses), _ = model64.apply(
                {"params": p, "batch_stats": stats64}, *(a.astype(jnp.float64) for a in args[:3]),
                *args[3:5], {k: v.astype(jnp.float64) for k, v in args[5].items()}, train=True,
                mutable=["batch_stats"])
            return sum(losses.values())

        jax64 = jax.grad(loss_fn)(jax.tree.map(lambda a: np.asarray(a, np.float64), params))
    jax64 = voxel_net_params_from_flax(jax.tree.map(np.asarray, jax64))
    jax32 = voxel_net_params_from_flax(jax.tree.map(np.asarray, ref_grads))
    ours = dict(model.named_parameters())
    assert set(jax64) == set(jax32) == set(ours)
    for n, p in m64.named_parameters():
        _close(jax64[n], p.grad.numpy(), rtol=1e-4, name=n)
        assert_nearer_float64(ours[n].grad, jax32[n], p.grad, n,
                              cap=1e-4 * float(p.grad.abs().max()))


# -- dropout ------------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_dropout_step_matches_jax(weights, monkeypatch, remat):
    """The JAX masks injected: the summed loss and every gradient against
    jax.value_and_grad of the JAX loss with the same dropout key, remat
    on and off on both sides (the masks: 20 sites, 2 per block and 1 per
    down stage's norm)."""
    cfg = _cfg(backbone3d={"drop": DROP})
    cfg["remat"] = remat
    key = jax.random.PRNGKey(7)
    masks = jax_dropout_masks(monkeypatch, _cfg(backbone3d={"drop": DROP}), weights, key)
    assert len(masks) == 2 * (1 + 2 + 3 + 2 + 1) + 2
    keep = float(torch.cat([m.flatten() for m in masks]).float().mean())
    assert abs(keep - (1 - DROP)) < 0.02
    ref_loss, ref_grads = _jax_value_and_grad(cfg, weights, key)
    model = _port(weights, cfg).train()
    loss, _ = voxel_net_forward_loss(model, batch_to_device(weights[2], "cpu"),
                                     draws=StepDraws(dropout=masks))
    loss.backward()
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-5)
    _check_grads(model, ref_grads)


def test_dropout_draws_replay_under_remat(weights):
    """Masks drawn from the step's generator: the same seed gives the same
    loss and gradients with and without remat (each block's masks are
    drawn before its checkpoint region); eval mode drops nothing; too few
    injected masks raise."""
    b = batch_to_device(weights[2], "cpu")
    grads = []
    for remat in (False, True):
        cfg = _cfg(backbone3d={"drop": DROP})
        cfg["remat"] = remat
        model = _port(weights, cfg).train()
        loss, _ = voxel_net_forward_loss(model, b, generator=torch.Generator().manual_seed(3))
        loss.backward()
        grads.append((float(loss), {n: p.grad.clone() for n, p in model.named_parameters()}))
    assert grads[0][0] == grads[1][0]
    for n, g in grads[0][1].items():
        _close(grads[1][1][n], g.numpy(), rtol=1e-6, name=n)
    eval_drop = _port_forward(_port(weights, _cfg(backbone3d={"drop": DROP})), weights[2], False)
    eval_plain = _port_forward(_port(weights), weights[2], False)
    assert float(eval_drop[0]) == float(eval_plain[0])
    with pytest.raises(ValueError, match="dropout masks"):
        _port_forward(_port(weights, _cfg(backbone3d={"drop": DROP})), weights[2], True,
                      masks=[])


# -- the loss split ------------------------------------------------------------------------

@pytest.mark.parametrize("split", ["pred", "none", "coarse_to_fine"])
def test_every_loss_split(weights, split):
    """Each value's outputs and losses against JAX's (train mode): 'pred'
    splits, every other value computes 'none' (the JAX head tests
    == 'pred' only); a value other than 'pred' or 'none' warns."""
    cfg = _cfg(heads={"tsdf": {"loss_split": split}})
    out, losses, _ = _jax_apply(cfg, weights, True)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        model = _port(weights, cfg)
    warned = [w for w in caught if "tsdf_loss_split" in str(w.message)]
    assert len(warned) == (split not in ("pred", "none"))
    _, metrics = _port_forward(model, weights[2], True)
    for k in losses:
        assert float(metrics[k]) == pytest.approx(float(losses[k]), rel=1e-5), k
    if split != "pred":
        ref_none = _jax_apply(_cfg(heads={"tsdf": {"loss_split": "none"}}), weights, True)[1]
        for k in losses:
            assert float(losses[k]) == float(ref_none[k]), k


# -- the flags the JAX VoxelNet ignores, and the one it cannot train -------------------

@pytest.mark.parametrize("encoder", [{"use_pointnet": True}, {"use_spatial": False},
                                     {"use_pointnet": True, "use_spatial": False}],
                         ids=["use_pointnet", "no_use_spatial", "both"])
def test_ignored_encoder_flags(weights, encoder):
    """The port warns, naming the flag, and computes the JAX package's
    outputs: the same as without the flag, in both packages, bit for bit."""
    cfg = _cfg(encoder=encoder)
    out = _jax_apply(cfg, weights, False)[0]
    plain = _jax_apply(CFG, weights, False)[0]
    with pytest.warns(UserWarning, match="VoxelNet ignores"):
        model = _port(weights, cfg).eval()
    _check_volumes(model, weights, out, False)
    b = batch_to_device(weights[2], "cpu")
    with torch.no_grad():
        vols = model(b["projection"], b["image"], VD)[0]
        vols_plain = _port(weights).eval()(b["projection"], b["image"], VD)[0]
    for k in out:
        np.testing.assert_array_equal(np.asarray(out[k]), np.asarray(plain[k]))
        assert torch.equal(vols[k], vols_plain[k]), k


def test_use_tsdf_false_stays_refused(weights):
    """The port refuses heads.use_tsdf false, naming why; the JAX train
    step cannot train it either: its heads return no loss, the sum of none
    is the int 0 and jax.value_and_grad raises TypeError."""
    cfg = _cfg(heads={"use_tsdf": False})
    with pytest.raises(NotImplementedError, match="use_tsdf false"):
        VoxelNet(config_from_dict(VoxelNetConfig, cfg))
    task = VoxelNetTask(cfg)
    params, stats, b = weights
    jparams = {k: v for k, v in params.items() if k != "heads3d"}
    state = create_train_state({"params": jparams, "batch_stats": stats}, task.tx)
    with pytest.raises(TypeError):
        task.train_step(state, {k: jnp.asarray(v) for k, v in b.items()}, jax.random.PRNGKey(0))


# -- bf16-mixed -----------------------------------------------------------------------------

def test_gn_dropout_bf16_near_jax_bf16(weights, monkeypatch):
    """GN with dropout under bf16-mixed, train mode, the JAX masks injected:
    the outputs and losses against JAX's op-by-op bf16 ones (the bounds of
    tests/test_torch_voxelnet.py, see the module docstring); every output
    float32."""
    cfg = _cfg(backbone3d={"drop": DROP})
    key = jax.random.PRNGKey(9)
    masks = jax_dropout_masks(monkeypatch, cfg, weights, key)
    out32, loss32, _ = _jax_apply(cfg, weights, True, key)
    out16, loss16, _ = _jax_apply(cfg, weights, True, key, "bf16-mixed")
    model = _port(weights, cfg, torch.bfloat16).train()
    b = batch_to_device(weights[2], "cpu")
    with torch.no_grad():
        vols, losses = model(b["projection"], b["image"], VD, None, {k: b[k] for k in KEYS},
                             dropout=DropoutDraws(DROP, masks))
    for k in out32:
        assert vols[k].dtype == torch.float32 and out16[k].dtype == jnp.float32
        ref16, ref32 = np.asarray(out16[k]), np.asarray(out32[k])
        gap = np.abs(ref16 - ref32).mean()
        err = np.abs(vols[k].numpy() - ref16).mean()
        assert err <= 0.5 * gap and err <= 1e-2, (k, err, gap)
    for k in loss32:
        assert abs(float(losses[k]) - float(loss16[k])) <= \
            0.5 * abs(float(loss16[k]) - float(loss32[k])) + 1e-6, k
