"""The GenNerf options under bf16-mixed in the port against the JAX
package's op-by-op bf16 on the CPU: SPADE, LayerNorm, the grid plane with
its UNet3D, the UNet's 'add' merge, the voxel_hash sparsifier and the
learned plane merger (distillation and the teacher volume, with this
file's helpers, in tests/test_torch_distill_bf16.py). One case per
option: the encode (the JAX draws
injected: presample, FPS start or voxel_hash's scores), the decode of
JAX's bf16 scene (for 'learn' also the merge of two encodes); then
VoxelNet's GroupNorm parameters through the npz and reference writers and
back. tests/test_torch_options_bf16_steps.py holds a train step of each
option against JAX's, with this file's cases and helpers.

Sizes are those of tests/test_torch_options.py (2 frames of 12x16, c_dim
8, H 32, 2 blocks, 16x16 planes, an 8^3 grid with a 2-level UNet3D of 4
maps); the teacher has 8 channels (patch 8, stride 4). JAX runs under
default_matmul_precision("highest"), the port with TF32 off.

Bounds, those of tests/test_torch_gennerf_bf16.py for eval mode. The
distance of a result is JAX's bf16 result against JAX's float32 result.
The port's bf16 result's mean absolute difference to JAX's bf16 result
must be at most a quarter of the mean distance, its largest difference
at most the largest distance (a floor of 1e-6 of the largest magnitude
for an output whose bf16 and float32 results coincide, and of 1e-5 for
the teacher volume, which both packages compute in float32: the float32
test's bound). Measured: every plane, grid and decode output bit for bit
equal to JAX's op-by-op bf16, the teacher volume 0.59 of its (float32)
distance. The dtypes of every output equal flax's: the planes bf16 (the
grid float32 after the UNet3D, which flax runs in float32: it is given
no dtype), the volume float32, the decode's features float32 and its
TSDF bf16. The references run op by op (`jax.disable_jit()`).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gennerf_tpu.models.gen_nerf import GenNerf as JGenNerf
from gennerf_tpu.train.tasks import GenNerfTask, VoxelNetTask
from gennerf_tpu_torch.models.config import GenNerfConfig, VoxelNetConfig, config_from_dict
from gennerf_tpu_torch.models.gen_nerf import SceneRepr
from gennerf_tpu_torch.models.voxel_net import VoxelNet
from gennerf_tpu_torch.train.step import StepDraws
from gennerf_tpu_torch.train.tasks import GenNerfTask as TTask
from gennerf_tpu_torch.train.tasks import load_flax_params
from gennerf_tpu_torch.utils.port_params import (
    gen_nerf_params_from_flax, load_params_npz, save_params_npz, voxel_net_npz_tree,
    voxel_net_params_from_flax,
)
from gennerf_tpu_torch.utils.port_reference import load_reference, write_reference
from test_torch_options import (  # noqa: F401
    CFG, H, M_GAUSS, OPTIONS, PRESAMPLE, R, T, VD, W, _encode_draws, _f32_highest, _frames,
    _merge, _randomize, _t,
)

import _torch_threads  # noqa: F401  (sizes torch's threads per xdist worker)

C_TEACHER = 8
TEACHER = {"teacher": {"type": "random_projection", "feature_dim": C_TEACHER, "seed": 3},
           "mlp": {"d_out_sem": C_TEACHER}}
# the options, then distillation and the teacher volume
# (tests/test_torch_distill_bf16.py)
CASES = {
    **OPTIONS,
    "distill_surface": _merge(TEACHER, {"loss": {"use_distill": True, "distill": {
        "weight": 0.5, "metric": "cosine", "mode": "surface"}}}),
    "distill_render": _merge(TEACHER, {"loss": {"use_distill": True, "distill": {
        "weight": 0.5, "metric": "cosine", "mode": "render", "render_rays": 8}}}),
    "auxiliary": _merge(TEACHER, {"encoder": {"use_auxiliary": True,
                                              "auxiliary_dim": C_TEACHER}}),
}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _dtype(x) -> str:
    return str(x.dtype).split(".")[-1]


def _near(ours, ref16, ref32, share: float, floor: float = 0.0, name=""):
    """mean|ours - ref16| <= share * mean|ref16 - ref32| and max|ours - ref16|
    <= max|ref16 - ref32| (each + floor * max|ref32|)."""
    o, a, b = _np(ours), _np(ref16), _np(ref32)
    assert o.shape == a.shape, name
    gap, err = np.abs(a - b), np.abs(o - a)
    tol = max(floor, 1e-6 if gap.max() == 0 else 0.0) * np.abs(b).max()
    assert err.mean() <= share * gap.mean() + tol, (name, err.mean(), gap.mean())
    assert err.max() <= gap.max() + tol, (name, err.max(), gap.max())


_CACHE = {}


def setup(*names):
    """(config, the JAX tasks in float32 and bf16, randomized params, the
    batch) of the options config with the cases `names` on."""
    if names not in _CACHE:
        cfg = CFG
        for name in names:
            cfg = _merge(cfg, CASES[name])
        b = _frames()
        task32 = GenNerfTask(cfg)

        def init_all(m, projection, image, depth, xyz, key, voxel_dim, origin):
            r = m.encode(projection, image, depth, key, voxel_dim, origin)
            return m.decode(m.merge(r, r), xyz, origin)

        with jax.default_matmul_precision("highest"):
            variables = jax.jit(functools.partial(task32.model.init, method=init_all),
                                static_argnums=(6,))(
                jax.random.PRNGKey(0), *(jnp.asarray(b[k]) for k in ("projection", "image",
                                                                     "depth")),
                jnp.zeros((1, 8, 3)), jax.random.PRNGKey(1), VD, jnp.zeros(3))
        tree = _randomize(jax.tree.map(lambda a: np.array(a, np.float32),
                                       dict(variables["params"])), np.random.default_rng(7))
        tree["mlp"]["alpha"] = np.asarray(0.7, np.float32)
        _CACHE[names] = (cfg, task32, GenNerfTask(cfg, "bf16-mixed"), tree, b)
    return _CACHE[names]


def _port(cfg, tree, dtype=torch.bfloat16):
    model = TTask.build(config_from_dict(GenNerfConfig, cfg), dtype)
    model.load_state_dict(gen_nerf_params_from_flax(tree))
    return model


def _step_draws(key, sparsifier, render: bool) -> StepDraws:
    """The JAX step's draws: (k_enc, k_sample) = split(key), (k_sparse,
    k_pre) = split(k_enc), (k_pix, k_pts) = split(k_sample), the render
    pixels' scores uniform(fold_in(k_sample, 7))."""
    k_enc, k_sample = jax.random.split(key)
    k_sparse, k_pre = jax.random.split(k_enc)
    k_pix, k_pts = jax.random.split(k_sample)
    start = (jax.random.uniform(k_sparse, (T, PRESAMPLE)) if sparsifier == "voxel_hash"
             else jax.random.randint(k_sparse, (T,), 0, PRESAMPLE))
    return StepDraws(
        sel=_t(jax.random.randint(k_pre, (T, PRESAMPLE), 0, H * W)), start=_t(start),
        scores=_t(jax.random.uniform(k_pix, (T, H * W))),
        noise=_t(jax.random.normal(k_pts, (T, R, M_GAUSS))),
        render_scores=_t(jax.random.uniform(jax.random.fold_in(k_sample, 7), (T, H * W)))
        if render else None)


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_encode_decode_bf16(name):
    """Eval mode: the encode at origin 0 (every plane, the grid), the
    decode of JAX's bf16 scene at points over and past the volume, and for
    'learn' the merge of two encodes."""
    check_encode_decode(name)


def check_encode_decode(name):
    """The encode (the volume and its counts too), the decode and for
    'learn' the merge of case `name` against JAX's op-by-op bf16."""
    cfg, task32, task16, tree, b = setup(name)
    v = {"params": tree}
    key = jax.random.PRNGKey(3)
    args = [jnp.asarray(b[k]) for k in ("projection", "image", "depth")]
    xyz = jnp.asarray(np.random.default_rng(5).uniform(-0.1, 1.4, (1, 120, 3)).astype(np.float32))

    def encode(model):
        return model.apply(v, *args, key, VD, jnp.zeros(3), method=JGenNerf.encode)

    def decode(model, r):
        return model.apply(v, r, xyz, jnp.zeros(3), method=JGenNerf.decode)

    with jax.disable_jit():
        r16 = encode(task16.model)
        d16 = decode(task16.model, r16)
    r32 = jax.jit(lambda: encode(task32.model))()
    d32 = jax.jit(lambda r: decode(task32.model, r))(r16)
    sel, start = _encode_draws(key, task32.cfg.encoder.pointnet.sparsifier)
    model = _port(cfg, tree).eval()
    with torch.no_grad():
        ours = model.encode(*(_t(b[k]) for k in ("projection", "image", "depth")), sel=sel,
                            start=start, voxel_dim=VD)
        scene = SceneRepr({k: _t(a.astype(jnp.float32)).to(
            torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32)
            for k, a in r16.planes.items()},
            None if r16.volume is None else _t(r16.volume),
            None if r16.valid is None else _t(r16.valid))
        dec = model.decode(scene, _t(xyz))
    assert set(ours.planes) == set(r16.planes)
    for k in r16.planes:
        assert _dtype(ours.planes[k]) == str(r16.planes[k].dtype), k
        _near(ours.planes[k], r16.planes[k], r32.planes[k], 0.25, name=k)
    if r16.volume is not None:
        assert ours.volume.dtype == torch.float32 and r16.volume.dtype == jnp.float32
        # the teacher computes in float32 in both (it takes no dtype)
        _near(ours.volume, r16.volume, r32.volume, 0.25, floor=1e-5, name="volume")
        np.testing.assert_array_equal(ours.valid.numpy(), np.asarray(r16.valid))
    for k in ("feat", "feat_geo", "feat_sem", "tsdf"):
        assert _dtype(dec[k]) == str(d16[k].dtype), k
        _near(dec[k], d16[k], d32[k], 0.25, name=k)
    if name == "learn":
        with jax.disable_jit():
            m16 = task16.model.apply(v, r16, r16, method=JGenNerf.merge)
        m32 = task32.model.apply(v, r16, r16, method=JGenNerf.merge)
        merged = model.merge(scene, scene)
        for k in r16.planes:
            assert merged.planes[k].dtype == torch.bfloat16 and m16.planes[k].dtype == jnp.bfloat16
            _near(merged.planes[k], m16.planes[k], m32.planes[k], 0.25, name="merge " + k)


# -- VoxelNet's GroupNorm parameters out and back -----------------------------------------

def test_group_norm_params_round_trip(tmp_path):
    """A bf16 VoxelNet with backbone3d.norm 'GN': its GroupNorm scale and
    bias through the params npz (flax's GroupNorm_0 level, no running
    statistics) and through the reference writer (the BatchNorm's names,
    weight and bias) and back, bit for bit; the npz tree is the JAX
    model's own tree shape."""
    cfg = {"type": "VoxelNet", "voxel_size": 0.08, "voxel_dim_train": [16, 16, 16],
           "voxel_dim_val": [16, 16, 16], "voxel_dim_test": [16, 16, 16],
           "encoder": {"use_spatial": True, "use_pointnet": False,
                       "spatial": {"backbone": "resnet18", "num_layers": 2,
                                   "feature_scale": 1.0, "blur_image": False}},
           "backbone3d": {"channels": [8, 16, 32], "layers_down": [1, 2, 3], "layers": [2, 1],
                          "norm": "GN", "drop": 0.1},
           "optimizer": {"type": "Adam", "lr": 0.001}}
    model = VoxelNet(config_from_dict(VoxelNetConfig, cfg), dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
    state = model.state_dict()
    assert "backbone3d.layers_down.0.0.bn2.weight" in state
    assert not any(k.startswith("backbone3d.") and "running_" in k for k in state)
    tree = voxel_net_npz_tree(state)
    jtree = jax.eval_shape(lambda: VoxelNetTask(cfg, "bf16-mixed").model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 1, 3, 4)), jnp.zeros((1, 1, 3, 32, 40)),
        jnp.zeros((1, 1, 32, 40)), (16, 16, 16), jnp.zeros(3)))
    shapes = jax.tree.map(lambda a: tuple(a.shape), {**jtree["params"]})
    assert jax.tree.map(np.shape, {k: tree[k] for k in shapes}) == shapes
    assert "GroupNorm_0" in tree["backbone3d"]["down0_b0"]["bn1"]
    save_params_npz(str(tmp_path / "p.npz"), tree)
    again = VoxelNet(config_from_dict(VoxelNetConfig, cfg), dtype=torch.bfloat16)
    load_flax_params(again, load_params_npz(str(tmp_path / "p.npz")))
    ref = voxel_net_params_from_flax(tree)
    for k, v in state.items():
        assert torch.equal(again.state_dict()[k], v) and torch.equal(ref[k], v), k
    write_reference(model, str(tmp_path / "m.ckpt"))
    third = VoxelNet(config_from_dict(VoxelNetConfig, cfg), dtype=torch.bfloat16)
    load_reference(third, str(tmp_path / "m.ckpt"))
    for k, v in state.items():
        assert torch.equal(third.state_dict()[k], v), k
